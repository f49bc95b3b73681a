"""Kernel 1: the decoder's 2x bicubic pyramid upsampler (the reference's
PyrUpBicubic2d), replacing frtm_tpu/ops/pallas/pyrup.py::pyr_up_bicubic_pallas.

(N, C, H, W) -> (N, C, 2H, 2W): replicate-pad 2, separable 4-tap Keys cubic
(A=-0.75) at phase offsets -0.25 / -0.75, pixel interleave, crop 1.
`pyr_up_bicubic` launches csrc/pyrup.cu on a CUDA tensor and runs the plain
version on a CPU tensor; the plain version is written from
frtm_tpu/models/seg_network.py::pyr_up_bicubic in the same operation order.
"""
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..resize import _cubic_kernel
from . import build


def _taps(phase):
    return [float(v) for v in _cubic_kernel(phase + np.arange(-1, 3, dtype=np.float64))
            .astype(np.float32)]


W_EVEN = _taps(-0.25)
W_ODD = _taps(-0.75)


def _filt4(x, taps, dim):
    """4-tap filter along `dim`; output length = in - 3."""
    n = x.shape[dim] - 3
    t0, t1, t2, t3 = taps
    return (t0 * x.narrow(dim, 0, n) + t1 * x.narrow(dim, 1, n)
            + t2 * x.narrow(dim, 2, n) + t3 * x.narrow(dim, 3, n))


def pyr_up_bicubic_plain(x: torch.Tensor) -> torch.Tensor:
    a = F.pad(x, (2, 2, 2, 2), mode="replicate")
    re = _filt4(a, W_EVEN, 2)      # rows: even / odd phase
    ro = _filt4(a, W_ODD, 2)
    i00 = _filt4(re, W_EVEN, 3)    # then columns
    i01 = _filt4(re, W_ODD, 3)
    i10 = _filt4(ro, W_EVEN, 3)
    i11 = _filt4(ro, W_ODD, 3)
    n, c, h, w = i00.shape
    j0 = torch.stack([i00, i01], dim=4).reshape(n, c, h, 2 * w)
    j1 = torch.stack([i10, i11], dim=4).reshape(n, c, h, 2 * w)
    out = torch.stack([j0, j1], dim=3).reshape(n, c, 2 * h, 2 * w)
    return out[:, :, 1:-1, 1:-1]


_TAPS_C = ((ctypes.c_float * 4)(*W_EVEN), (ctypes.c_float * 4)(*W_ODD))
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]


def pyr_up_bicubic(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) float32 -> (N, C, 2H, 2W)."""
    if x.device.type == "cpu":
        return pyr_up_bicubic_plain(x)
    build.check_cuda_tensor(x, "pyr_up_bicubic input", 4)
    n, c, h, w = x.shape
    y = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    build.launch("pyrup", "frtm_pyrup_f32", _ARGTYPES, x.data_ptr(), y.data_ptr(),
                 n * c, h, w, *_TAPS_C, device=x.device)
    return y
