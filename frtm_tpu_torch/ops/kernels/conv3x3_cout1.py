"""Kernel 2: 3x3 stride-1 zero-padded conv from Cin channels to one output
channel (the decoder head `up.conv2`), replacing
frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas.

`conv3x3_cout1` launches csrc/conv3x3_cout1.cu on CUDA tensors and runs the
plain version — the same 9 * Cin tap sum written with tensor ops — on CPU
tensors.
"""
import ctypes

import torch
import torch.nn.functional as F

from . import build


def conv3x3_cout1_plain(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x (N, C, H, W), w (1, C, 3, 3), b (1,) or None -> (N, 1, H, W)."""
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
    if x.device.type == "cpu":
        return conv3x3_cout1_plain(x, w, b)
    build.check_cuda_tensor(x, "conv3x3_cout1 input", 4)
    build.check_cuda_tensor(w, "conv3x3_cout1 weight", 4)
    n, c, h, wd = x.shape
    if tuple(w.shape) != (1, c, 3, 3):
        raise ValueError(f"conv3x3_cout1: weight shape {tuple(w.shape)} != (1, {c}, 3, 3)")
    if b is not None:
        build.check_cuda_tensor(b, "conv3x3_cout1 bias", 1)
        if b.numel() != 1:
            raise ValueError("conv3x3_cout1: bias must have one element")
    y = torch.empty((n, 1, h, wd), dtype=x.dtype, device=x.device)
    build.launch("conv3x3_cout1", "frtm_conv3x3_cout1_f32", _ARGTYPES,
                 x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                 y.data_ptr(), n, c, h, wd, device=x.device)
    return y
