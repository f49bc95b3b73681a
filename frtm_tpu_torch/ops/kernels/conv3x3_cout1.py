"""Kernel 2: 3x3 stride-1 zero-padded conv from Cin channels to one output
channel (the decoder head `up.conv2`), replacing
frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas.

`conv3x3_cout1` launches csrc/conv3x3_cout1.cu on CUDA tensors and runs the
plain version — the same 9 * Cin tap sum written with tensor ops — on CPU
tensors.

float32 and bfloat16, one kernel instance each; input, weight and bias share
the type. In bfloat16 both the kernel and the plain version upcast planes and
(bfloat16-rounded) weights to float32, accumulate in float32 and round the
sum once, as the TPU kernel does; the JAX decoder's own bfloat16 convolution
rounds differently.
"""
import ctypes

import torch
import torch.nn.functional as F

from . import build


def conv3x3_cout1_plain(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x (N, C, H, W), w (1, C, 3, 3), b (1,) or None -> (N, 1, H, W)."""
    if x.dtype == torch.bfloat16:
        return conv3x3_cout1_plain(x.float(), w.float(),
                                   None if b is None else b.float()).to(torch.bfloat16)
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


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]


def conv3x3_cout1(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    instance = build.instance_of(x, "conv3x3_cout1 input")
    if w.dtype != x.dtype or (b is not None and b.dtype != x.dtype):
        raise TypeError(f"conv3x3_cout1: input {x.dtype}, weight {w.dtype} and bias "
                        f"{None if b is None else b.dtype} must share one type")
    if x.device.type == "cpu":
        return conv3x3_cout1_plain(x, w, b)
    build.check_cuda_tensor(x, "conv3x3_cout1 input", 4, x.dtype)
    build.check_cuda_tensor(w, "conv3x3_cout1 weight", 4, x.dtype)
    n, c, h, wd = x.shape
    if tuple(w.shape) != (1, c, 3, 3):
        raise ValueError(f"conv3x3_cout1: weight shape {tuple(w.shape)} != (1, {c}, 3, 3)")
    if b is not None:
        build.check_cuda_tensor(b, "conv3x3_cout1 bias", 1, x.dtype)
        if b.numel() != 1:
            raise ValueError("conv3x3_cout1: bias must have one element")
    y = torch.empty((n, 1, h, wd), dtype=x.dtype, device=x.device)
    build.launch("conv3x3_cout1", f"frtm_conv3x3_cout1_{instance}", _ARGTYPES,
                 x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                 y.data_ptr(), n, c, h, wd, device=x.device, variant=instance)
    return y
