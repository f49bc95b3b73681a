"""Resizing with PyTorch `F.interpolate(align_corners=False)` semantics,
as dense separable matrices (the same formulation as frtm_tpu/ops/resize.py,
so the port and the JAX package share one set of interpolation weights).

The weights are built once per (in, out, mode) in float64 numpy, stored as
float32, and applied as two matmuls on NCHW tensors: rows first, then columns.
"""
from functools import lru_cache

import numpy as np
import torch


def _source_coords(in_size: int, out_size: int) -> np.ndarray:
    """Half-pixel source coordinates (align_corners=False)."""
    scale = in_size / out_size
    return (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5


@lru_cache(maxsize=None)
def _linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bilinear weights matching torch's upsample_bilinear2d: the
    source coordinate clamps at 0, upper overflow clamps the gather index."""
    src = np.maximum(_source_coords(in_size, out_size), 0.0)
    i0 = np.floor(src).astype(np.int64)
    w1 = src - i0
    W = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(W, (rows, np.clip(i0, 0, in_size - 1)), 1.0 - w1)
    np.add.at(W, (rows, np.clip(i0 + 1, 0, in_size - 1)), w1)
    return W.astype(np.float32)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with A=-0.75 (torch / OpenCV convention)."""
    x = np.abs(x)
    return np.where(
        x < 1.0,
        (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0,
        np.where(x < 2.0, a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


@lru_cache(maxsize=None)
def _cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bicubic weights matching torch's upsample_bicubic2d."""
    src = _source_coords(in_size, out_size)
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    W = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    for tap in range(-1, 3):
        np.add.at(W, (rows, np.clip(i0 + tap, 0, in_size - 1)), _cubic_kernel(tap - t))
    return W.astype(np.float32)


_MATRICES = {"bilinear": _linear_matrix, "bicubic": _cubic_matrix}


@lru_cache(maxsize=64)
def _matrix_on(mode: str, in_size: int, out_size: int, device: torch.device):
    return torch.from_numpy(_MATRICES[mode](in_size, out_size)).to(device)


def resize(x: torch.Tensor, size, mode: str = "bilinear") -> torch.Tensor:
    """Resize the two trailing spatial dims of a (..., H, W) tensor."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    dtype = x.dtype
    xf = x.float()
    if in_h != out_h:
        xf = torch.matmul(_matrix_on(mode, in_h, out_h, x.device), xf)
    if in_w != out_w:
        xf = torch.matmul(xf, _matrix_on(mode, in_w, out_w, x.device).T)
    return xf.to(dtype)


def interpolate(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize to `size` (a no-op when the size already matches)."""
    return resize(x, size, "bilinear")


def adaptive_cat(tensors, ref_index: int = 0) -> torch.Tensor:
    """Resize every NCHW tensor to the ref tensor's spatial size, concat on C."""
    size = tensors[ref_index].shape[-2:]
    return torch.cat([interpolate(t, size) for t in tensors], dim=1)
