"""Affine image warping with cv2.warpAffine semantics — the plain PyTorch
version of kernel 3 (ops/kernels/warp_affine.py), copied from
frtm_tpu/ops/warp.py::warp_affine and _resample.

The forward 2x3/3x3 matrix is inverted on the host; each output pixel is
mapped through the inverse to source coordinates and sampled with nearest /
bilinear / bicubic (Keys A=-0.75) taps; out-of-range taps contribute zero
(cv2 BORDER_CONSTANT). Images are channel planes (C, H, W), the port's
layout. Every float operation runs in the order the CUDA kernel uses, so on
the card the two agree bit for bit.
"""
import numpy as np
import torch

MODES = ("nearest", "bilinear", "bicubic")


def inverse_coefficients(H) -> np.ndarray:
    """Forward 2x3 or 3x3 matrix -> the nine float32 entries of its inverse
    (the 3x3 form, so the homogeneous divide of frtm_tpu's warp is kept)."""
    H = np.asarray(H, np.float32)
    if H.shape == (2, 3):
        H = np.concatenate([H, np.asarray([[0.0, 0.0, 1.0]], np.float32)], axis=0)
    if H.shape != (3, 3):
        raise ValueError(f"warp matrix must be 2x3 or 3x3, got {H.shape}")
    return np.linalg.inv(H).astype(np.float32).reshape(9)


def _inverse_map(hinv, out_h, out_w, device):
    yo, xo = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=device),
                            torch.arange(out_w, dtype=torch.float32, device=device),
                            indexing="ij")
    h = [float(v) for v in hinv]
    xs = h[0] * xo + h[1] * yo + h[2]
    ys = h[3] * xo + h[4] * yo + h[5]
    w = h[6] * xo + h[7] * yo + h[8]
    return xs / w, ys / w


def _sample(src, ix, iy):
    """src[:, iy, ix] with a zero for out-of-range taps: (C, OH, OW)."""
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
    """Sample (C, H, W) float32 src at float coords xs, ys (both (OH, OW))."""
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
    out_h, out_w = int(size[0]), int(size[1])
    xs, ys = _inverse_map(hinv, out_h, out_w, src.device)
    return _resample(src, xs, ys, mode)
