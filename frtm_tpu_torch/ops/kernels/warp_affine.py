"""Kernel 3: the affine image warp (cv2.warpAffine semantics), replacing
frtm_tpu/ops/pallas/warp.py::warp_affine_pallas.

`warp_affine` takes (C, H, W) channel planes and a forward 2x3 or 3x3 matrix,
inverts the matrix on the host, and launches csrc/warp_affine.cu on a CUDA
tensor or runs the plain version (ops/warp.py) on a CPU tensor. Sources of
another dtype (uint8 labels) are warped in float32 and cast back, as in
frtm_tpu/ops/warp.py.

The kernel has two variants, and `plan_warp` picks one per call on the host:
STAGED for an affine map whose tile source box, in all channels, fits the
shared-memory budget (every warp of the augmenter), DIRECT otherwise (a
projective map, or a map that shrinks the source so much, or so many
channels, that the box does not fit).
`build.VARIANTS["warp_affine"]` counts the launches of each.
"""
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..warp import MODES, inverse_coefficients, warp_affine_plain
from . import build

# csrc/warp_affine.cu's staged variant: the output tile of a block (rows,
# columns) and the shared memory that holds all channels of its source box
STAGED_TILE = (16, 32)
STAGED_SMEM_BYTES = 96 * 1024

# taps per axis, per mode
_TAPS = {"nearest": 1, "bilinear": 2, "bicubic": 4}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int]


@dataclass(frozen=True)
class WarpPlan:
    variant: str            # "staged" or "direct"
    box: tuple = (0, 0)     # staged: (rows, row pitch) a block stages per channel


def plan_warp(hinv, size, mode: str, channels: int) -> WarpPlan:
    """STAGED with the box a block stages per channel, or DIRECT, for one
    warp of `channels` planes. The box bounds every tile's: over a tile of
    TY x TX outputs the map moves by |h0| (TX-1) + |h1| (TY-1) in x (|h3|,
    |h4| in y), its float32 values stray from that by a few ulps of the
    largest coordinate, the floors add 1 and the taps n - 1; two more
    columns let the kernel widen a box to whole column pairs, and the width
    is even. DIRECT where the box's channels exceed the shared memory. The
    row pitch is 8 mod 32 words where the memory allows: a warp's 8x4
    output patch then reads its taps from distinct banks."""
    h = np.asarray(hinv, np.float64).reshape(9)
    if not (h[6] == 0 and h[7] == 0 and h[8] == 1):
        return WarpPlan("direct")
    n = _TAPS[mode]
    ty, tx = STAGED_TILE
    oh, ow = int(size[0]), int(size[1])
    reach = max(abs(h[0]) * ow + abs(h[1]) * oh + abs(h[2]),
                abs(h[3]) * ow + abs(h[4]) * oh + abs(h[5]), 1.0)
    slack = 16 * reach * 2.0 ** -24
    bw = (int(abs(h[0]) * (tx - 1) + abs(h[1]) * (ty - 1) + slack) + n + 4) // 2 * 2
    bh = int(abs(h[3]) * (tx - 1) + abs(h[4]) * (ty - 1) + slack) + n + 1
    if 4 * channels * bw * bh > STAGED_SMEM_BYTES:
        return WarpPlan("direct")
    pitch = bw + (8 - bw) % 32
    if 4 * channels * pitch * bh > STAGED_SMEM_BYTES:
        pitch = bw
    return WarpPlan("staged", (bh, pitch))


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
    plan = plan_warp(hinv, (oh, ow), mode, c)
    args = [srcf.data_ptr(), out.data_ptr(), c, h, w, oh, ow,
            (ctypes.c_float * 9)(*hinv.tolist()), MODES.index(mode)]
    if plan.variant == "staged":
        build.launch("warp_affine", "frtm_warp_affine_staged_f32",
                     _ARGTYPES + [ctypes.c_int] * 2, *args, plan.box[1], plan.box[0],
                     device=src.device, variant="staged")
    else:
        build.launch("warp_affine", "frtm_warp_affine_f32", _ARGTYPES, *args,
                     device=src.device, variant="direct")
    return out.to(src.dtype)
