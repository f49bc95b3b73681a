"""Affine image warping with cv2.warpAffine semantics — the plain PyTorch
version of kernel 3 (ops/kernels/warp_affine.py), copied from
frtm_tpu/ops/warp.py::warp_affine and _resample.

The forward 2x3/3x3 matrix is inverted on the host in float32, in the
operation order of frtm_tpu's `jnp.linalg.inv`; each output pixel is
mapped through the inverse to source coordinates and sampled with nearest /
bilinear / bicubic (Keys A=-0.75) taps; out-of-range taps contribute zero
(cv2 BORDER_CONSTANT). Images are channel planes (C, H, W), the port's
layout. Every float operation runs in the order the CUDA kernel uses, so on
the card the two agree bit for bit.

`warp_affine_batched_plain` is the plain version of every launch of the
kernel: S maps at once (`warp_affine_plain` is its one-map case) and,
optionally, trailing planes sampled nearest. It evaluates every map in the
same tensor operations (their number does not grow with S), each element
with the roundings of a warp by that map alone. `warp_perspective` and `remap` are the counterparts of
frtm_tpu/ops/warp.py's: the first through kernel 3 on a CUDA tensor, the
second plain on both devices (the JAX package resamples it in XLA).
"""
import numpy as np
import torch

MODES = ("nearest", "bilinear", "bicubic")

_f32 = np.float32


def _fma(a, b, c):
    """a * b + c in float32, rounded once (a fused multiply-add)."""
    p = float(a) * float(b)                 # exact: 24-bit factors
    s = p + float(c)
    t = s - p
    lo = (p - (s - t)) + (float(c) - t)     # p + c == s + lo exactly
    r = _f32(s)
    if lo != 0.0 and float(r) != s:
        # s rounds to float32 correctly unless it is a float32 midpoint; then
        # the exact sum lies on the side of lo
        other = np.nextafter(r, _f32(np.inf if float(r) < s else -np.inf))
        if (float(r) + float(other)) / 2 == s:
            return max(r, other) if lo > 0 else min(r, other)
    return r


def _inverse3(m):
    """Inverse of a 3x3 float32 matrix with the float32 roundings of
    `jnp.linalg.inv` on the CPU: LAPACK sgetrf, then strsm with a unit lower
    and a non-unit upper factor against the permuted identity, as the
    OpenBLAS that SciPy ships computes them. sgetrf is left-looking: each
    column takes the earlier columns' updates (a dot product of rounded
    products, or an FMA chain), then its pivot, the first of largest
    magnitude, then scales the multipliers by the pivot's reciprocal. The
    solves scale by reciprocal diagonals; the upper solve takes row 2's
    term as a rounded product and row 1's with an FMA."""
    a = [[_f32(v) for v in row] for row in m]
    perm = [0, 1, 2]
    one = _f32(1)

    def pivot(j):
        p = max(range(j, 3), key=lambda i: (abs(a[i][j]), -i))
        if a[p][j] == 0:
            raise ValueError("warp matrix is singular")
        a[j], a[p] = a[p], a[j]
        perm[j], perm[p] = perm[p], perm[j]
        return one / a[j][j]

    r = pivot(0)
    a[1][0], a[2][0] = a[1][0] * r, a[2][0] * r
    a[1][1] = a[1][1] - a[1][0] * a[0][1]
    a[2][1] = a[2][1] - a[2][0] * a[0][1]
    r = pivot(1)
    a[2][1] = a[2][1] * r
    a[1][2] = a[1][2] - a[1][0] * a[0][2]
    a[2][2] = a[2][2] - _fma(a[2][1], a[1][2], a[2][0] * a[0][2])
    if a[2][2] == 0:
        raise ValueError("warp matrix is singular")
    inv_diag = [one / a[i][i] for i in range(3)]

    out = np.empty((3, 3), np.float32)
    for col in range(3):
        b = [_f32(perm[i] == col) for i in range(3)]
        y1 = _fma(-b[0], a[1][0], b[1])
        y2 = b[2] - _fma(a[2][1], y1, a[2][0] * b[0])
        x2 = y2 * inv_diag[2]
        c0 = b[0] - a[0][2] * x2
        x1 = (y1 - a[1][2] * x2) * inv_diag[1]
        x0 = _fma(-x1, a[0][1], c0) * inv_diag[0]
        out[:, col] = x0, x1, x2
    return out


def inverse_coefficients(H) -> np.ndarray:
    """Forward 2x3 or 3x3 matrix -> the nine float32 entries of its inverse
    (the 3x3 form, so the homogeneous divide of frtm_tpu's warp is kept),
    bit-equal to `jnp.linalg.inv` of the float32 matrix on the CPU."""
    H = np.asarray(H, np.float32)
    if H.shape == (2, 3):
        H = np.concatenate([H, np.asarray([[0.0, 0.0, 1.0]], np.float32)], axis=0)
    if H.shape != (3, 3):
        raise ValueError(f"warp matrix must be 2x3 or 3x3, got {H.shape}")
    return _inverse3(H).reshape(9)


def _grid(out_h, out_w, device):
    yo, xo = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=device),
                            torch.arange(out_w, dtype=torch.float32, device=device),
                            indexing="ij")
    return xo, yo


def _inverse_map(hinvs, out_h, out_w, device):
    """The source coordinates of every output pixel under S inverse maps
    ((S, 9)): two (S, OH, OW) tensors."""
    xo, yo = _grid(out_h, out_w, device)
    h = torch.from_numpy(np.asarray(hinvs, np.float32).reshape(-1, 9, 1, 1)).to(device)
    xs = h[:, 0] * xo + h[:, 1] * yo + h[:, 2]
    ys = h[:, 3] * xo + h[:, 4] * yo + h[:, 5]
    w = h[:, 6] * xo + h[:, 7] * yo + h[:, 8]
    return xs / w, ys / w


def _sample(src, ix, iy):
    """src[:, iy, ix] with a zero for out-of-range taps: (C,) + ix.shape."""
    c, h, w = src.shape
    inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    vals = src.reshape(c, h * w)[:, idx.reshape(-1)].reshape(c, *ix.shape)
    return vals * inb.to(src.dtype)


def cubic_weight(x, a: float = -0.75):
    """Keys cubic weight at distance x; x**3 is (x*x)*x, as in the kernel."""
    x = x.abs()
    x2 = x * x
    x3 = x2 * x
    return torch.where(
        x < 1.0, (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        torch.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a,
                    torch.zeros_like(x)))


def _resample(src, xs, ys, mode):
    """Sample (C, H, W) float32 src at float coords xs, ys (of one shape,
    (OH, OW) or (S, OH, OW)): (C,) + xs.shape."""
    if mode == "nearest":
        ix = torch.floor(xs + 0.5).to(torch.int64)
        iy = torch.floor(ys + 0.5).to(torch.int64)
        return _sample(src, ix, iy)

    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    ix0 = x0.to(torch.int64)
    iy0 = y0.to(torch.int64)
    out = torch.zeros((src.shape[0],) + xs.shape, dtype=torch.float32, device=src.device)

    if mode == "bilinear":
        taps = [(0, 1.0 - fx, 0, 1.0 - fy), (1, fx, 0, 1.0 - fy),
                (0, 1.0 - fx, 1, fy), (1, fx, 1, fy)]
        for dx, wx, dy, wy in taps:
            out = out + (wx * wy) * _sample(src, ix0 + dx, iy0 + dy)
        return out

    if mode == "bicubic":
        wxs = [cubic_weight(tap - fx) for tap in range(-1, 3)]
        wys = [cubic_weight(tap - fy) for tap in range(-1, 3)]
        for dy in range(-1, 3):
            row = torch.zeros_like(out)
            for dx in range(-1, 3):
                row = row + wxs[dx + 1] * _sample(src, ix0 + dx, iy0 + dy)
            out = out + wys[dy + 1] * row
        return out

    raise ValueError(f"unknown warp mode: {mode}")


def warp_affine_plain(src: torch.Tensor, hinv, size, mode: str = "bicubic") -> torch.Tensor:
    """Warp (C, H, W) float32 planes by the inverse map `hinv`
    (inverse_coefficients of the forward matrix) to (C, size[0], size[1])."""
    return warp_affine_batched_plain(src, np.asarray(hinv)[None], size, mode)[0]


def warp_affine_batched_plain(src: torch.Tensor, hinvs, size, mode: str = "bicubic",
                              nearest_from=None) -> torch.Tensor:
    """Warp (C, H, W) float32 planes by S inverse maps `hinvs` ((S, 9)) to
    (S, C, size[0], size[1]); the planes from `nearest_from` on are sampled
    nearest, the ones before it in `mode`. Each output equals the warp by
    its map alone, in its planes' mode, bit for bit."""
    out_h, out_w = int(size[0]), int(size[1])
    xs, ys = _inverse_map(hinvs, out_h, out_w, src.device)
    k = src.shape[0] if nearest_from is None else int(nearest_from)
    if not 0 <= k <= src.shape[0]:
        raise ValueError(f"nearest_from {nearest_from} outside 0 .. {src.shape[0]}")
    out = _resample(src[:k], xs, ys, mode)
    if k < src.shape[0]:
        out = torch.cat([out, _resample(src[k:], xs, ys, "nearest")])
    return out.transpose(0, 1).contiguous()


def warp_perspective(src: torch.Tensor, H, size, mode: str = "bicubic") -> torch.Tensor:
    """Warp (C, H, W) planes by a forward 3x3 perspective matrix, with the
    homogeneous divide that `warp_affine` also performs; the counterpart of
    frtm_tpu/ops/warp.py::warp_perspective. Kernel 3 on a CUDA tensor (its
    direct variant for a projective map), the plain version on a CPU one."""
    H = np.asarray(H, np.float32)
    if H.shape != (3, 3):
        raise ValueError(f"perspective transform must be 3x3, got {H.shape}")
    from .kernels.warp_affine import warp_affine
    return warp_affine(src, H, size, mode)


def remap(src: torch.Tensor, map_x, map_y, mode: str = "bilinear") -> torch.Tensor:
    """Coordinate-map warp of (C, H, W) planes: out[:, y, x] = src sampled at
    (map_x[y, x], map_y[y, x]), zero outside the source, in the source's
    dtype (float32 or uint8, sampled in float32); the counterpart of
    frtm_tpu/ops/warp.py::remap. Plain torch on either device.

    :param map_x, map_y: (OH, OW) source coordinates (tensors or arrays)"""
    if mode not in MODES:
        raise ValueError(f"unknown warp mode: {mode}")
    xs = torch.as_tensor(map_x, dtype=torch.float32).to(src.device)
    ys = torch.as_tensor(map_y, dtype=torch.float32).to(src.device)
    if xs.shape != ys.shape or xs.dim() != 2:
        raise ValueError(f"maps must be two (OH, OW) arrays, got {tuple(xs.shape)} and "
                         f"{tuple(ys.shape)}")
    return _resample(src.float(), xs, ys, mode).to(src.dtype)
