"""The plain backward of kernels 1 and 2 (what their autograd Functions run
on a CPU tensor) against jax.vjp of the JAX decoder's ops, which is the
gradient the JAX trainer takes. The CUDA backward kernels are held against
these plain versions on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.models.seg_network import pyr_up_bicubic as jax_pyrup
from frtm_tpu.ops.conv import conv2d as jax_conv2d
from frtm_tpu_torch.ops.kernels import (LAUNCHES, conv3x3_cout1, conv3x3_cout1_input_grad,
                                        conv3x3_cout1_weight_grad, pyr_up_bicubic,
                                        pyr_up_bicubic_backward)
from frtm_tpu_torch.ops.kernels.conv3x3_cout1 import pair_width
from frtm_tpu_torch.ops.kernels.pyrup import FOLD_FIRST, FOLD_LAST, PYRDOWN_TAPS


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def close_to_peak(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


# (N, H, W, C): H and W of 1 and 2 fold every padded row onto one source row
@pytest.mark.parametrize("shape", [(2, 7, 5, 3), (1, 1, 1, 2), (1, 2, 9, 1), (2, 12, 16, 8)])
def test_pyrup_backward_plain_matches_jax_vjp(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    gy = rng.randn(shape[0], 2 * shape[1], 2 * shape[2], shape[3]).astype(np.float32)
    _, vjp = jax.vjp(jax_pyrup, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(gy))
    got = pyr_up_bicubic_backward(nchw(gy), nchw(x).shape)
    close_to_peak(nhwc(got), np.asarray(want), 1e-5)
    # and through the autograd Function, as the decoder takes it
    xt = nchw(x).requires_grad_()
    pyr_up_bicubic(xt).backward(nchw(gy))
    assert torch.equal(xt.grad, got)


# one compiled program per shape: op by op, JAX compiles each op of the decoder
_jax_pyrup_vjp = jax.jit(lambda x, gy: jax.vjp(jax_pyrup, x)[1](gy)[0])


def pyrdown_gather(gy, axis):
    """csrc/pyrup_bwd.cu's formula along one axis of a float32 array: at
    index h, the stride-2 8-tap filter PYRDOWN_TAPS over gy[2h - 3 ..] (zero
    outside gy), with the folded padded rows FOLD_FIRST added into the taps
    of index 0 and FOLD_LAST into those of index n - 1."""
    f, first, last = (np.float32(t) for t in (PYRDOWN_TAPS, FOLD_FIRST, FOLD_LAST))
    g = np.moveaxis(gy, axis, -1)
    n = g.shape[-1] // 2
    zeros = np.zeros(g.shape[:-1] + (3,), np.float32)
    p = np.concatenate([zeros, g, zeros], -1)        # p[2h + i] = gy[2h - 3 + i]
    taps = np.tile(f, (n, 1))
    taps[0, 3:6] += first                            # gy[0], gy[1], gy[2]
    taps[n - 1, 2:5] += last                         # gy[2n - 3], gy[2n - 2], gy[2n - 1]
    out = taps[:, 0] * p[..., 0:2 * n:2]
    for i in range(1, 8):
        out = out + taps[:, i] * p[..., i:i + 2 * n:2]
    return np.moveaxis(out, -1, axis)


# (N, H, W, C): every H and W from 1 (both folds onto one index) to 5 (the
# first size with an index that neither fold nor the zero border reaches),
# an odd W of 11, and a training-like plane
@pytest.mark.parametrize("shape", [(1, h, w, 2) for h in range(1, 6) for w in range(1, 6)]
                         + [(1, 6, 11, 3), (2, 12, 16, 8)])
def test_pyrup_backward_kernel_formula_matches_jax_vjp(rng, shape):
    """The backward kernel cannot run here; its formula and tables can."""
    x = rng.randn(*shape).astype(np.float32)
    gy = rng.randn(shape[0], 2 * shape[1], 2 * shape[2], shape[3]).astype(np.float32)
    want = _jax_pyrup_vjp(jnp.asarray(x), jnp.asarray(gy))
    close_to_peak(pyrdown_gather(pyrdown_gather(gy, 1), 2), np.asarray(want), 1e-5)


# (N, H, W, C): the input-gradient kernel's edges too: W of 1, 2 and 3 (a
# pair with its second column outside, every column a border one), an odd W,
# H = 1 (both neighbouring dy rows outside) and C = 17 (a masked last group
# of one channel)
@pytest.mark.parametrize("shape", [(2, 13, 17, 6), (1, 1, 1, 1), (3, 5, 4, 32),
                                   (2, 6, 1, 3), (1, 4, 2, 2), (2, 5, 3, 4), (1, 7, 9, 3),
                                   (2, 1, 10, 5), (1, 6, 8, 17)])
def test_head_conv_backward_plain_matches_jax_vjp(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[3], 1) * 0.3).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    gy = rng.randn(*shape[:3], 1).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, b: jax_conv2d(x, w, b, tapsum=False),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = (np.asarray(g) for g in vjp(jnp.asarray(gy)))
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    dx = conv3x3_cout1_input_grad(nchw(gy), wt, nchw(x).shape)
    dw, db = conv3x3_cout1_weight_grad(nchw(x), nchw(gy))
    close_to_peak(nhwc(dx), jdx, 1e-5)
    close_to_peak(np.transpose(dw.numpy(), (2, 3, 1, 0)), jdw, 1e-5)
    close_to_peak(db.numpy(), jdb, 1e-5)
    # through the autograd Function: the same values
    xt, wr, br = nchw(x).requires_grad_(), wt.clone().requires_grad_(), \
        torch.from_numpy(b).requires_grad_()
    conv3x3_cout1(xt, wr, br).backward(nchw(gy))
    assert torch.equal(xt.grad, dx) and torch.equal(wr.grad, dw) and torch.equal(br.grad, db)


def _lane_tree(v, lanes):
    """Lane 0's sum after __shfl_down_sync steps lanes / 2 .. 1 over axis 1."""
    off = lanes // 2
    while off:
        v = v[:, :off] + v[:, off:2 * off]
        off //= 2
    return v[:, 0]


def dw_stream(x, dy, rows, lanes=32, warps=2, sum_threads=256):
    """csrc/conv3x3_cout1_dw.cu's order in numpy float32 (each FMA as a
    product and a sum): per image, stripe of `rows` x rows and segment of
    `lanes * warps` column pairs, a thread walks its pair u0, u0 + 1 down
    the stripe with a ring of three dy-row windows (columns u0 - 1 .. u0 +
    2: its own pair, the neighbours from the adjacent lanes, lanes 0 and
    lanes - 1 their own halo load) and sums taps and its dy; the segment
    reduces once (a shuffle tree per warp, then the warps in turn) into
    partials stored output by output; pass 2 sums each output's row (per
    thread of `sum_threads` in order, a shuffle tree per warp, the warps in
    turn). The kernel's channel groups and chunks split only which threads
    hold a channel's sums, so the model keeps every channel in each thread."""
    n, c, h, w = x.shape
    pairs = lanes * warps
    segs = -(-((w + 1) // 2) // pairs)
    stripes = -(-h // rows)
    cols = 2 * pairs * segs
    xp = np.zeros((n, c, h, cols), np.float32)
    xp[..., :w] = x
    dp = np.zeros((n, h + 2, cols + 2), np.float32)    # dp[b, r + 1, u + 1] = dy[b, 0, r, u]
    dp[:, 1:h + 1, 1:w + 1] = dy[:, 0]
    lane = np.arange(pairs) % lanes
    tiles = n * stripes * segs
    partials = np.full((9 * c + 1, tiles), np.nan, np.float32)
    for b in range(n):
        for s in range(stripes):
            y0, y1 = s * rows, min(s * rows + rows, h)
            for seg in range(segs):
                u0 = 2 * (seg * pairs + np.arange(pairs))

                def window(r):
                    row = dp[b, r + 1]
                    d0, d1 = row[u0 + 1], row[u0 + 2]
                    left = np.where(lane == 0, row[u0], np.roll(d1, 1))
                    right = np.where(lane == lanes - 1, row[u0 + 3], np.roll(d0, -1))
                    return np.stack([left, d0, d1, right], -1)

                ring = {y0 - 1: window(y0 - 1), y0: window(y0)}
                acc = np.zeros((pairs, c, 9), np.float32)
                dsum = np.zeros(pairs, np.float32)
                for y in range(y0, y1):
                    ring[y + 1] = window(y + 1)
                    xa, xb = xp[b, :, y][:, u0].T, xp[b, :, y][:, u0 + 1].T
                    for i in range(3):
                        d = ring[y - i + 1]
                        for j in range(3):
                            t = acc[:, :, 3 * i + j] + xa * d[:, None, 2 - j]
                            acc[:, :, 3 * i + j] = t + xb * d[:, None, 3 - j]
                    dsum = dsum + (ring[y][:, 1] + ring[y][:, 2])
                sums = np.concatenate([acc.reshape(pairs, 9 * c), dsum[:, None]], 1)
                per_warp = _lane_tree(sums.reshape(warps, lanes, -1), lanes)
                tile = (b * stripes + s) * segs + seg
                partials[:, tile] = per_warp[0]
                for k in range(1, warps):
                    partials[:, tile] = partials[:, tile] + per_warp[k]
    assert not np.isnan(partials).any()
    steps = -(-tiles // sum_threads)
    padded = np.zeros((9 * c + 1, steps * sum_threads), np.float32)
    padded[:, :tiles] = partials
    padded = padded.reshape(9 * c + 1, steps, sum_threads)
    per_thread = padded[:, 0]
    for k in range(1, steps):
        per_thread = per_thread + padded[:, k]
    per_warp = _lane_tree(per_thread.reshape(-1, 32), 32).reshape(9 * c + 1, -1)
    out = per_warp[:, 0]
    for k in range(1, per_warp.shape[1]):
        out = out + per_warp[:, k]
    return out


_DW_ROWS = 8      # the kernel's stripe where the grid fits one wave


def _jax_head_conv_weight_vjp(x, w, b, gy):
    _, vjp = jax.vjp(lambda w, b: jax_conv2d(x, w, b, tapsum=False), w, b)
    return vjp(gy)


# H around the stripe (1, 2, R - 1, R, R + 1, 2R + 1), W of 1 to 3 and 17
# (two segments of the model's 4-lane warps, the second one pair wide, its
# second column outside), C over a masked channel group (1, 3, 5) and a whole
# chunk (16); two images, so tiles cross an image's edge
@pytest.mark.parametrize("h", [1, 2, _DW_ROWS - 1, _DW_ROWS, _DW_ROWS + 1, 2 * _DW_ROWS + 1])
@pytest.mark.parametrize("w", [1, 2, 3, 17])
@pytest.mark.parametrize("c", [1, 3, 5, 16])
def test_head_conv_weight_grad_kernel_order_matches_jax_vjp(rng, h, w, c):
    """The weight-gradient kernel cannot run here; its walk can: a tap
    turned the wrong way or a halo row or column lost shows here."""
    x = rng.randn(2, h, w, c).astype(np.float32)
    gy = rng.randn(2, h, w, 1).astype(np.float32)
    wt = (rng.randn(3, 3, c, 1) * 0.3).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    jdw, jdb = _jax_head_conv_weight_vjp(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                         jnp.asarray(gy))
    got = dw_stream(nchw(x).numpy(), nchw(gy).numpy(), _DW_ROWS, lanes=4)
    close_to_peak(np.transpose(got[:9 * c].reshape(1, c, 3, 3), (2, 3, 1, 0)),
                  np.asarray(jdw), 1e-5)
    close_to_peak(got[9 * c:], np.asarray(jdb), 1e-5)


def dx_walk(dy, w, rows, lanes=32, max_warps=14):
    """csrc/conv3x3_cout1_dx.cu's walk in numpy float32 (each FMA as a
    product and a sum): per image, stripe of `rows` rows and segment of
    column pairs (whole rows up to `max_warps` warps of `lanes` lanes, wider
    rows split into segments of equal warps), a thread walks its pair u0, u0
    + 1 down the stripe with a ring of three dy-row windows (columns u0 - 1
    .. u0 + 2: its own pair, the neighbours from the adjacent lanes, lanes 0
    and lanes - 1 their own halo load) and sums each value's 9 taps in the
    order t = 3 i + j from 0. Channel groups split only which threads hold a
    channel, so the model keeps every channel in each thread."""
    n, _, h, wd = dy.shape
    c = w.shape[1]
    taps = w[0].reshape(c, 9)
    across = -(-((wd + 1) // 2) // lanes)
    segs = -(-across // max_warps)
    span = -(-across // segs) * lanes          # column pairs in a segment
    cols = 2 * span * segs
    dp = np.zeros((n, h + 2, cols + 2), np.float32)    # dp[b, r + 1, u + 1] = dy[b, 0, r, u]
    dp[:, 1:h + 1, 1:wd + 1] = dy[:, 0]
    out = np.full((n, c, h, cols), np.nan, np.float32)
    lane = np.arange(span) % lanes
    for b in range(n):
        for y0 in range(0, h, rows):
            for seg in range(segs):
                u0 = 2 * (seg * span + np.arange(span))

                def window(r):
                    row = dp[b, r + 1]
                    d0, d1 = row[u0 + 1], row[u0 + 2]
                    left = np.where(lane == 0, row[u0], np.roll(d1, 1))
                    right = np.where(lane == lanes - 1, row[u0 + 3], np.roll(d0, -1))
                    return np.stack([left, d0, d1, right], -1)

                ring = {y0 - 1: window(y0 - 1), y0: window(y0)}
                for y in range(y0, min(y0 + rows, h)):
                    ring[y + 1] = window(y + 1)
                    d = (ring[y + 1], ring[y], ring[y - 1])     # taps i = 0, 1, 2
                    a = np.zeros((c, span), np.float32)
                    a1 = np.zeros((c, span), np.float32)
                    for t in range(9):
                        i, j = divmod(t, 3)
                        a = a + taps[:, t, None] * d[i][None, :, 2 - j]
                        a1 = a1 + taps[:, t, None] * d[i][None, :, 3 - j]
                    row = out[b, :, y]
                    row[:, u0], row[:, u0 + 1] = a, a1
    assert not np.isnan(out[..., :wd]).any()
    return out[..., :wd]


_DX_ROWS = 3      # the kernel's stripe (kRows)


# H around the stripe (1, 2, R, R + 1, 2R + 1), W of 1 to 3, 17 (two segments
# of the model's blocks of two 4-lane warps, the second one pair wide, its
# second column outside) and 33 (three); C over a masked channel group (1, 5);
# two images, so stripes cross an image's edge
@pytest.mark.parametrize("h", [1, 2, _DX_ROWS, _DX_ROWS + 1, 2 * _DX_ROWS + 1])
@pytest.mark.parametrize("w", [1, 2, 3, 17, 33])
@pytest.mark.parametrize("c", [1, 5])
def test_head_conv_input_grad_kernel_order_matches_jax_vjp(rng, h, w, c):
    """The input-gradient kernel cannot run here; its walk can: a tap turned
    the wrong way or a halo row or column lost shows here."""
    x = rng.randn(2, h, w, c).astype(np.float32)
    gy = rng.randn(2, h, w, 1).astype(np.float32)
    wt = (rng.randn(3, 3, c, 1) * 0.3).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_conv2d(x, jnp.asarray(wt), jnp.asarray(b), tapsum=False),
                     jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(gy))
    w_oihw = np.ascontiguousarray(np.transpose(wt, (3, 2, 0, 1)))
    got = dx_walk(nchw(gy).numpy(), w_oihw, _DX_ROWS, lanes=4, max_warps=2)
    close_to_peak(np.transpose(got, (0, 2, 3, 1)), np.asarray(jdx), 1e-5)


# (W, pointers, floats per load or store): 8 bytes only where every row and
# every tensor starts 8-byte aligned
@pytest.mark.parametrize("w,ptrs,want", [
    (854, (0x7f0000000000, 0x7f0000100000), 2), (854, (0x7f0000000004, 0x7f0000100000), 1),
    (854, (0x7f0000000000, 0x7f0000100004), 1), (853, (0x7f0000000000, 0x7f0000100000), 1),
    (2, (8, 16, 24), 2), (1, (8,), 1), (128, (), 2), (130, (8, 12), 1)])
def test_pair_width_takes_8_bytes_only_where_every_row_is_aligned(w, ptrs, want):
    assert pair_width(w, *ptrs) == want


def test_inference_records_no_graph_and_cpu_backward_counts_no_launch():
    x = torch.randn(1, 2, 4, 5, requires_grad=True)
    w = torch.randn(1, 2, 3, 3, requires_grad=True)
    with torch.no_grad():
        assert pyr_up_bicubic(x).grad_fn is None
        assert conv3x3_cout1(x, w).grad_fn is None
    assert pyr_up_bicubic(x.detach()).grad_fn is None
    before = dict(LAUNCHES)
    conv3x3_cout1(pyr_up_bicubic(x), torch.randn(1, 2, 3, 3, requires_grad=True)).sum().backward()
    assert LAUNCHES == before
    assert x.grad is not None and x.grad.shape == x.shape


def test_bf16_backward_raises():
    x = torch.randn(1, 2, 4, 5).bfloat16().requires_grad_()
    with pytest.raises(TypeError):
        pyr_up_bicubic(x).sum().backward()
    w = torch.randn(1, 2, 3, 3).bfloat16().requires_grad_()
    with pytest.raises(TypeError):
        conv3x3_cout1(x, w).sum().backward()
