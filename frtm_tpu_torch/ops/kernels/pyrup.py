"""Kernel 1: the decoder's 2x bicubic pyramid upsampler (the reference's
PyrUpBicubic2d), replacing frtm_tpu/ops/pallas/pyrup.py::pyr_up_bicubic_pallas.

(N, C, H, W) -> (N, C, 2H, 2W): replicate-pad 2, separable 4-tap Keys cubic
(A=-0.75) at phase offsets -0.25 / -0.75, pixel interleave, crop 1.
`pyr_up_bicubic` launches csrc/pyrup.cu (float32) or csrc/pyrup_bf16.cu
(bfloat16) on a CUDA tensor and runs the plain
version on a CPU tensor; the plain version is written from
frtm_tpu/models/seg_network.py::pyr_up_bicubic in the same operation order.

float32 and bfloat16, one kernel instance each. In bfloat16 both the kernel
and the plain version compute in float32 on the upcast input and round once
at the end, as the TPU kernel does (its output takes the input's type). The
JAX decoder's own bfloat16 path (pyr_up_bicubic on a bfloat16 array) rounds
after every product and sum instead, so the port lies closer to the float32
result than that does.

Gradient: `pyr_up_bicubic` is differentiable (a torch.autograd.Function)
where its input requires a gradient and autograd records. Its backward is
the adjoint of the upsampler, in float32 only: csrc/pyrup_bwd.cu on the card,
`pyr_up_bicubic_backward_plain` (autograd of the plain forward) on the CPU.
Along each axis the adjoint is a stride-2 8-tap filter, PYRDOWN_TAPS, over
the output gradient (zero outside it), plus the padded rows that the
replicate padding folds onto the first and last index (FOLD_FIRST,
FOLD_LAST); the kernel is given those tables. The kernel reads the gradient
in 16-, 8- or 4-byte loads (variants "v4", "v2", "v1"), the widest its rows'
alignment allows. The bfloat16 instance serves inference only; a backward
through it raises.
Under `torch.no_grad`, or on an input that needs no gradient, the forward
runs as a plain call and records nothing.
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

# The adjoint along one axis of length n (csrc/pyrup_bwd.cu): for the output
# gradient g (length 2n, zero outside it),
#   gx[h] = sum_i PYRDOWN_TAPS[i] * g[2h - 3 + i]
#           + (h == 0) * FOLD_FIRST . g[0:3] + (h == n - 1) * FOLD_LAST . g[2n-3:2n],
# the two folds being padded indices 0, 1 and n + 2, n + 3.
PYRDOWN_TAPS = [W_EVEN[3], W_ODD[3], W_EVEN[2], W_ODD[2], W_EVEN[1], W_ODD[1], W_EVEN[0],
                W_ODD[0]]
FOLD_FIRST = [float(np.float32(W_ODD[0]) + np.float32(W_ODD[1])), W_EVEN[0], W_ODD[0]]
FOLD_LAST = [W_EVEN[3], W_ODD[3], float(np.float32(W_EVEN[2]) + np.float32(W_EVEN[3]))]


def _filt4(x, taps, dim):
    """4-tap filter along `dim`; output length = in - 3."""
    n = x.shape[dim] - 3
    t0, t1, t2, t3 = taps
    return (t0 * x.narrow(dim, 0, n) + t1 * x.narrow(dim, 1, n)
            + t2 * x.narrow(dim, 2, n) + t3 * x.narrow(dim, 3, n))


def pyr_up_bicubic_plain(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return pyr_up_bicubic_plain(x.float()).to(torch.bfloat16)
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


# the library of each instance: the bfloat16 one is its own design
_SOURCES = {"f32": "pyrup", "bf16": "pyrup_bf16"}
_TAPS_C = ((ctypes.c_float * 4)(*W_EVEN), (ctypes.c_float * 4)(*W_ODD))
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]


def _forward(x: torch.Tensor) -> torch.Tensor:
    instance = build.instance_of(x, "pyr_up_bicubic input")
    if x.device.type == "cpu":
        return pyr_up_bicubic_plain(x)
    build.check_cuda_tensor(x, "pyr_up_bicubic input", 4, x.dtype)
    n, c, h, w = x.shape
    y = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    build.launch("pyrup", f"frtm_pyrup_{instance}", _ARGTYPES, x.data_ptr(), y.data_ptr(),
                 n * c, h, w, *_TAPS_C, device=x.device, variant=instance,
                 source=_SOURCES[instance])
    return y


def pyr_up_bicubic_backward_plain(gy: torch.Tensor, in_shape) -> torch.Tensor:
    """The input gradient of pyr_up_bicubic_plain for output gradient gy
    (N, C, 2H, 2W), taken by autograd; the map is linear, so the input's
    values do not enter."""
    with torch.enable_grad():
        x = torch.zeros(tuple(in_shape), dtype=gy.dtype, device=gy.device, requires_grad=True)
        (gx,) = torch.autograd.grad(pyr_up_bicubic_plain(x), x, gy)
    return gx


_BWD_TAPS_C = tuple((ctypes.c_float * len(t))(*t)
                    for t in (PYRDOWN_TAPS, FOLD_FIRST, FOLD_LAST))
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 *[ctypes.POINTER(ctypes.c_float)] * 3, ctypes.c_int]


def pyr_up_bicubic_backward(gy: torch.Tensor, in_shape) -> torch.Tensor:
    """(N, C, 2H, 2W) float32 output gradient -> (N, C, H, W) input gradient:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if gy.dtype != torch.float32:
        raise TypeError("pyr_up_bicubic backward: float32 only (the bfloat16 instance "
                        f"serves inference), got a {gy.dtype} gradient")
    n, c, h, w = in_shape
    if tuple(gy.shape) != (n, c, 2 * h, 2 * w):
        raise ValueError(f"pyr_up_bicubic backward: gradient {tuple(gy.shape)} for input "
                         f"{tuple(in_shape)}")
    if gy.device.type == "cpu":
        return pyr_up_bicubic_backward_plain(gy, in_shape)
    gy = gy.contiguous()
    build.check_cuda_tensor(gy, "pyr_up_bicubic output gradient", 4)
    gx = torch.empty((n, c, h, w), dtype=gy.dtype, device=gy.device)
    # floats per load: 4 where gy's rows are 16-byte aligned (W even, the
    # pointer 16-byte aligned), else 2 where the pointer is 8-byte aligned
    ptr = gy.data_ptr()
    vec = 4 if w % 2 == 0 and ptr % 16 == 0 else 2 if ptr % 8 == 0 else 1
    build.launch("pyrup_bwd", "frtm_pyrup_bwd_f32", _BWD_ARGTYPES, ptr, gx.data_ptr(),
                 n * c, h, w, *_BWD_TAPS_C, vec, device=gy.device, variant=f"v{vec}")
    return gx


class _PyrUpBicubic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.in_shape = tuple(x.shape)
        return _forward(x)

    @staticmethod
    def backward(ctx, gy):
        return pyr_up_bicubic_backward(gy, ctx.in_shape)


def pyr_up_bicubic(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) float32 or bfloat16 -> (N, C, 2H, 2W) of the same type;
    differentiable where x requires a gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _PyrUpBicubic.apply(x)
    return _forward(x)
