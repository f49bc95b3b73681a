"""Kernel 3: the affine image warp (cv2.warpAffine semantics), replacing
frtm_tpu/ops/pallas/warp.py::warp_affine_pallas.

`warp_affine` takes (C, H, W) channel planes and a forward 2x3 or 3x3 matrix,
inverts the matrix on the host, and launches csrc/warp_affine.cu on a CUDA
tensor or runs the plain version (ops/warp.py) on a CPU tensor. Sources of
another dtype (uint8 labels) are warped in float32 and cast back, as in
frtm_tpu/ops/warp.py.
"""
import ctypes

import torch

from ..warp import MODES, inverse_coefficients, warp_affine_plain
from . import build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int]


def warp_affine(src: torch.Tensor, H, size, mode: str = "bicubic") -> torch.Tensor:
    """Warp (C, H, W) planes by the forward matrix H to (C, size[0], size[1])."""
    if mode not in MODES:
        raise ValueError(f"unknown warp mode: {mode}")
    if src.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"warp_affine: expected float32 or uint8, got {src.dtype}")
    hinv = inverse_coefficients(H)
    srcf = src.float()
    if src.device.type == "cpu":
        out = warp_affine_plain(srcf, hinv, size, mode)
        return out.to(src.dtype)
    build.check_cuda_tensor(srcf, "warp_affine source", 3)
    c, h, w = srcf.shape
    oh, ow = int(size[0]), int(size[1])
    out = torch.empty((c, oh, ow), dtype=torch.float32, device=src.device)
    build.launch("warp_affine", "frtm_warp_affine_f32", _ARGTYPES,
                 srcf.data_ptr(), out.data_ptr(), c, h, w, oh, ow,
                 (ctypes.c_float * 9)(*hinv.tolist()), MODES.index(mode),
                 device=src.device)
    return out.to(src.dtype)
