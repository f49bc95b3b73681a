"""The plain versions of the port's kernels 1 and 2 (a frozen copy of
frtm_tpu_torch/ops/kernels/pyrup.py::pyr_up_bicubic_plain and
conv3x3_cout1.py::conv3x3_cout1_plain), float32 only."""
import numpy as np
import torch
import torch.nn.functional as F

from .resize import _cubic_kernel


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


def pyr_up_bicubic(x: torch.Tensor) -> torch.Tensor:
    """Kernel 1: the 2x bicubic pyramid upsampler, (N, C, H, W) -> (N, C, 2H, 2W)."""
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


def conv3x3_cout1(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """Kernel 2: x (N, C, H, W), w (1, C, 3, 3), b (1,) or None -> (N, 1, H, W)."""
    n, c, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = None
    for di in range(3):
        for dj in range(3):
            t = torch.einsum("c,nchw->nhw", w[0, :, di, dj],
                             xp[:, :, di:di + h, dj:dj + wd])
            acc = t if acc is None else acc + t
    y = acc[:, None]
    return y if b is None else y + b.reshape(1, 1, 1, 1)
