"""Row-sharded operations: height sharding over torch.distributed.

The JAX package shards a frame's height over a mesh axis and lets GSPMD
insert the halo exchanges (frtm_tpu/parallel/spatial.py). The port runs one
process per card, so every exchange is written here. A spatial group of n
ranks (`mesh`: its `group`, this process's `rank` in it and its `size`)
shares a global height H by the row plan of `constrain`
(frtm_tpu/runtime/sequence_tracker.py): a level whose H divides by n is
sharded, rank r holding rows [r H/n, (r+1) H/n); any other level is
replicated, every rank holding all of it. An operation is given its input's
global height H and may take the input either way (the local height tells
which: H/n rows or H); its output follows the plan of the output's height.

* A stencil (a convolution of any kernel, stride and padding, the 3x3/s2
  max pool, kernels 1 and 2) takes from its neighbours the rows its output
  rows read beyond its own, `exchange_rows`: one all-gather of every rank's
  boundary rows, O(W C) bytes, never the map. The rows beyond the true
  image edge are the operation's own padding: zeros for a convolution,
  -inf for the max pool, the edge row for kernel 1's replicate padding.
* A strided stencil keeps the split even where the input's rows are its
  stride times the output's; where they are not, or where a halo is deeper
  than a neighbour's rows, or where the output does not divide, the input is
  gathered (`gather_rows`) and this rank's rows computed from the whole of
  it. Exchanges are never chained over several hops.
* A resize multiplies this rank's rows of the resize matrix
  (ops/resize.py) by the input rows they read: all of a replicated input,
  the band of a sharded one (its own rows and a halo).
* A spatial mean sums this rank's rows, all-reduces the sum and divides by
  the global count.
* Kernels 1 and 2 run unchanged on the rows they read (pad, compute, crop):
  on a shard of h rows with a halo of k rows each side they compute
  2 k / h more rows than they keep.

Every rank issues the same collectives in the same order: what an operation
exchanges follows from the shapes alone, never from a rank's own values.
Data moves as bytes (a uint8 view), so any type crosses any backend bit for
bit. With no mesh, or a group of one, every function here is the unsharded
operation and nothing else. Where `mesh` has a `traffic` dict, each
exchange, gather and all-reduce adds its calls and bytes to it.
"""
from functools import lru_cache

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .kernels import conv3x3_cout1 as head_kernel, pyr_up_bicubic as pyrup_kernel
from .resize import _MATRICES, _matrix_on, resize as plain_resize
from .collectives import all_reduce_sum


def active(mesh) -> bool:
    """Whether `mesh` shards anything: a group of more than one rank."""
    return mesh is not None and mesh.size > 1


def sharded(H: int, mesh) -> bool:
    """The row plan: a level of global height H is sharded over the group
    where H divides by its size, else replicated."""
    return active(mesh) and H % mesh.size == 0


def row_span(H: int, mesh):
    """This rank's rows [lo, hi) of a level of global height H (all of it
    where the level is replicated)."""
    if not sharded(H, mesh):
        return 0, H
    h = H // mesh.size
    return mesh.rank * h, (mesh.rank + 1) * h


def take_rows(x, H: int, mesh):
    """This rank's rows of a replicated (..., H, W) tensor, by the plan."""
    lo, hi = row_span(H, mesh)
    return x if (lo, hi) == (0, H) else x[..., lo:hi, :]


def _is_full(x, H):
    return x.shape[-2] == H


def _record(mesh, kind, nbytes):
    traffic = getattr(mesh, "traffic", None)
    if traffic is not None:
        traffic[kind] = traffic.get(kind, 0) + 1
        traffic[kind + "_bytes"] = traffic.get(kind + "_bytes", 0) + nbytes


def all_gather_bytes(t, group, size):
    """Every rank's `t` (equal shapes) over `group`, moved as bytes: a list
    of `size` tensors of t's type."""
    t = t.contiguous()
    flat = t.reshape(-1).view(torch.uint8)
    outs = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(outs, flat, group=group)
    return [o.view(t.dtype).view(t.shape) for o in outs]


def _edge_fill(x, rows, side, fill):
    """`rows` rows of padding beyond the image's `side` edge of x."""
    shape = (*x.shape[:-2], rows, x.shape[-1])
    if fill == "zeros":
        return x.new_zeros(shape)
    if fill == "-inf":
        return x.new_full(shape, float("-inf"))
    if fill == "replicate":
        edge = x[..., :1, :] if side == "top" else x[..., -1:, :]
        return edge.expand(shape)
    raise ValueError(f"fill {fill!r}: 'zeros', '-inf' or 'replicate'")


def exchange_rows(x, top: int, bottom: int, mesh, fill: str = "zeros"):
    """A shard (..., h, W) with `top` rows of the rank above and `bottom`
    rows of the rank below attached: (..., top + h + bottom, W). At the
    image's edges the rows are `fill` ('zeros', '-inf' or 'replicate').
    Raises where a halo is deeper than a shard."""
    if top == 0 and bottom == 0:
        return x
    h = x.shape[-2]
    if top > h or bottom > h:
        raise ValueError(f"halo ({top}, {bottom}) deeper than a shard of {h} rows")
    send = torch.cat([x[..., :bottom, :], x[..., h - top:, :]], dim=-2)
    got = all_gather_bytes(send, mesh.group, mesh.size)
    _record(mesh, "exchange", send.numel() * send.element_size() * mesh.size)
    r, n = mesh.rank, mesh.size
    above = got[r - 1][..., bottom:, :] if r > 0 else _edge_fill(x, top, "top", fill)
    below = got[r + 1][..., :bottom, :] if r < n - 1 else _edge_fill(x, bottom, "bottom", fill)
    return torch.cat([above, x, below], dim=-2)


def gather_rows(x, H: int, mesh):
    """A level of global height H, sharded or replicated, as the whole
    (..., H, W) tensor on every rank."""
    if _is_full(x, H) or not active(mesh):
        return x
    parts = all_gather_bytes(x, mesh.group, mesh.size)
    _record(mesh, "gather", x.numel() * x.element_size() * mesh.size)
    return torch.cat(parts, dim=-2)


def spatial_mean(x, H: int, mesh):
    """x.mean(dim=(-2, -1), keepdim=True) of the global level: the local
    sum (in float32), all-reduced, over the global count."""
    if _is_full(x, H) or not active(mesh):
        return x.mean(dim=(-2, -1), keepdim=True)
    s = x.sum(dim=(-2, -1), keepdim=True, dtype=torch.float32)
    _record(mesh, "all_reduce", s.numel() * 4 * mesh.size)
    return (all_reduce_sum(s, mesh.group) / (H * x.shape[-1])).to(x.dtype)


def _padded(x, a, e, H, fill):
    """Rows [a, e) of a whole (..., H, W) tensor, `fill` beyond its edges."""
    parts = [_edge_fill(x, -a, "top", fill)] if a < 0 else []
    parts.append(x[..., max(a, 0):min(e, H), :])
    if e > H:
        parts.append(_edge_fill(x, e - H, "bottom", fill))
    return torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0].contiguous()


def _stencil_rows(x, H, H_out, k, s, p, mesh, fill):
    """The input rows, with their padding, that this rank's output rows of
    a stencil (kernel k, stride s, padding p in height) read; the output is
    sharded (the caller checks). A shard whose rows are s times the
    output's takes a halo of p rows above and k - s - p below (a negative
    one drops its own last rows); otherwise the input is gathered."""
    lo, hi = row_span(H_out, mesh)
    if not _is_full(x, H):
        h = x.shape[-2]
        top, bottom = p, k - s - p
        if h == s * (hi - lo) and top <= h and bottom <= h:
            xs = x[..., :h + bottom, :] if bottom < 0 else x
            return exchange_rows(xs, top, max(bottom, 0), mesh, fill)
        x = gather_rows(x, H, mesh)
    return _padded(x, lo * s - p, (hi - 1) * s - p + k, H, fill)


def conv2d(x, w, b=None, stride: int = 1, padding=None, H: int = None, mesh=None):
    """F.conv2d with padding (ph, pw) (default k // 2 each) on a level of
    global height H; the output's rows by the plan."""
    kh, kw = w.shape[-2:]
    ph, pw = (kh // 2, kw // 2) if padding is None else padding
    if not active(mesh):
        return F.conv2d(x, w, b, stride=stride, padding=(ph, pw))
    H_out = (H + 2 * ph - kh) // stride + 1
    if not sharded(H_out, mesh):
        return F.conv2d(gather_rows(x, H, mesh), w, b, stride=stride, padding=(ph, pw))
    rows = _stencil_rows(x, H, H_out, kh, stride, ph, mesh, "zeros")
    return F.conv2d(rows, w, b, stride=stride, padding=(0, pw))


def max_pool_3x3_s2(x, H: int = None, mesh=None):
    """The ResNet stem's 3x3/s2 max pool (padding 1, -inf) on a level of
    global height H."""
    if not active(mesh):
        return F.max_pool2d(x, 3, 2, 1)
    H_out = (H - 1) // 2 + 1
    if not sharded(H_out, mesh):
        return F.max_pool2d(gather_rows(x, H, mesh), 3, 2, 1)
    rows = _stencil_rows(x, H, H_out, 3, 2, 1, mesh, "-inf")
    return F.max_pool2d(rows, 3, 2, (0, 1))


@lru_cache(maxsize=64)
def _band(mode, in_h, out_h, lo, hi, a, e, device):
    """Rows lo:hi of the (out_h, in_h) resize matrix over input rows [a, e),
    zero where a row lies outside [0, in_h)."""
    m = _matrix_on(mode, in_h, out_h, device)[lo:hi]
    band = m.new_zeros((hi - lo, e - a))
    band[:, max(a, 0) - a:min(e, in_h) - a] = m[:, max(a, 0):min(e, in_h)]
    return band


@lru_cache(maxsize=256)
def _reach(mode, in_h, out_h, lo, hi):
    """Input rows [c0, c1) that output rows [lo, hi) of the matrix read."""
    nz = torch.from_numpy(_MATRICES[mode](in_h, out_h)[lo:hi]).ne(0).any(0).nonzero()
    return int(nz[0]), int(nz[-1]) + 1


def resize(x, size, mode: str = "bilinear", H: int = None, mesh=None):
    """ops/resize.py's resize of a level of global height H to the global
    size; the output's rows by the plan."""
    if not active(mesh):
        return plain_resize(x, size, mode)
    out_h, out_w = int(size[0]), int(size[1])
    in_w = x.shape[-1]
    if H == out_h:                      # the rows stay; only the width resizes
        x = take_rows(x, H, mesh) if _is_full(x, H) else x
        return plain_resize(x, (x.shape[-2], out_w), mode)
    if not sharded(out_h, mesh):
        return plain_resize(gather_rows(x, H, mesh), size, mode)
    lo, hi = row_span(out_h, mesh)
    if _is_full(x, H):
        rows, a = x, 0
    else:
        h, n = x.shape[-2], mesh.size
        spans = [_reach(mode, H, out_h, r * (out_h // n), (r + 1) * (out_h // n))
                 for r in range(n)]
        top = max(0, *(r * h - c0 for r, (c0, _) in enumerate(spans)))
        bottom = max(0, *(c1 - (r + 1) * h for r, (_, c1) in enumerate(spans)))
        if top <= h and bottom <= h:
            rows, a = exchange_rows(x, top, bottom, mesh), mesh.rank * h - top
        else:
            rows, a = gather_rows(x, H, mesh), 0
    band = _band(mode, H, out_h, lo, hi, a, a + rows.shape[-2], x.device)
    y = torch.matmul(band, rows.float())
    if in_w != out_w:
        y = torch.matmul(y, _matrix_on(mode, in_w, out_w, x.device).T)
    return y.to(x.dtype)


def pyr_up_bicubic(x, H: int = None, mesh=None):
    """Kernel 1 on a level of global height H (output 2H): the input rows
    that this rank's output rows read, 2 beyond them each side with the
    replicate padding at the image's edges, through the kernel, cropped."""
    if not active(mesh):
        return pyrup_kernel(x)
    H_out = 2 * H
    if not sharded(H_out, mesh):
        return pyrup_kernel(gather_rows(x, H, mesh))
    lo, hi = row_span(H_out, mesh)
    a = lo // 2 - 2                     # the first input row read, global
    if not _is_full(x, H) and x.shape[-2] >= 2:
        rows = exchange_rows(x, 2, 2, mesh, "replicate")
    else:
        rows = _padded(gather_rows(x, H, mesh), a, (hi - 1) // 2 + 3, H, "replicate")
    y = pyrup_kernel(rows)
    return y[..., lo - 2 * a:hi - 2 * a, :]


def conv3x3_cout1(x, w, b=None, H: int = None, mesh=None):
    """Kernel 2 on a level of global height H: this rank's rows with one
    row of each neighbour (zeros at the image's edges), through the kernel,
    cropped."""
    if not active(mesh):
        return head_kernel(x, w, b)
    if not sharded(H, mesh):
        return head_kernel(gather_rows(x, H, mesh), w, b)
    lo, hi = row_span(H, mesh)
    rows = (_padded(x, lo - 1, hi + 1, H, "zeros") if _is_full(x, H)
            else exchange_rows(x, 1, 1, mesh, "zeros"))
    return head_kernel(rows, w, b)[..., 1:-1, :]
