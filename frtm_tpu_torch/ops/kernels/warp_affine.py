"""Kernel 3: the affine image warp (cv2.warpAffine semantics), replacing
frtm_tpu/ops/pallas/warp.py::warp_affine_pallas.

`warp_affine` takes (C, H, W) channel planes and a forward 2x3 or 3x3 matrix,
inverts the matrix on the host, and launches csrc/warp_affine.cu on a CUDA
tensor or runs the plain version (ops/warp.py) on a CPU tensor. Sources of
another dtype (uint8 labels) are warped in float32 and cast back, as in
frtm_tpu/ops/warp.py. `warp_affine_batched` warps one source by S forward
matrices in one launch, (S, C, OH, OW). Both take `nearest_from`: the planes
from that index on are sampled nearest, the ones before it in `mode`, all
under the same map, in one launch (a mixed launch: the augmenter's RGBA
target and its label).

The kernel has two variants, and `plan_warp` picks one per launch on the
host: STAGED where every map is affine and the tile source box, in all
channels sampled in `mode` (a mixed launch reads its nearest planes from
global memory), fits the shared-memory budget (every warp of the augmenters),
DIRECT otherwise (a projective map, or a map that shrinks the source so
much, or so many channels, that the box does not fit). A batched launch
stages the largest box of its maps, or takes DIRECT for all of them.
`build.VARIANTS["warp_affine"]` counts the launches of each: "staged" and
"direct" for one map, "staged_batched" and "direct_batched" for the
launches of `warp_affine_batched`.
"""
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..warp import MODES, inverse_coefficients, warp_affine_batched_plain
from . import build

# csrc/warp_affine.cu's staged variant: the output tile of a block (rows,
# columns) and the shared memory that holds all channels of its source box
STAGED_TILE = (16, 32)
STAGED_SMEM_BYTES = 96 * 1024

# taps per axis, per mode
_TAPS = {"nearest": 1, "bilinear": 2, "bicubic": 4}

# the launch's maps ride in its parameters (csrc/warp_affine.cu, kMaxMaps)
MAX_MAPS = 32

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 4


@dataclass(frozen=True)
class WarpPlan:
    variant: str            # "staged" or "direct"
    box: tuple = (0, 0)     # staged: (rows, row pitch) a block stages per channel


def plan_warp(hinv, size, mode: str, channels: int) -> WarpPlan:
    """STAGED with the box a block stages per channel, or DIRECT, for a
    launch of `channels` planes under one inverse map (9 entries) or several
    ((S, 9)). The box bounds every tile's: over a tile of TY x TX outputs
    the map moves by |h0| (TX-1) + |h1| (TY-1) in x (|h3|, |h4| in y), its
    float32 values stray from that by a few ulps of the largest coordinate,
    the floors add 1 and the taps n - 1; two more columns let the kernel
    widen a box to whole column pairs, and the width is even. Several maps
    take the largest box of any. DIRECT where a map is projective or the
    box's channels exceed the shared memory. The row pitch is 8 mod 32
    words where the memory allows: a warp's 8x4 output patch then reads its
    taps from distinct banks."""
    hs = np.asarray(hinv, np.float64).reshape(-1, 9)
    if not ((hs[:, 6] == 0) & (hs[:, 7] == 0) & (hs[:, 8] == 1)).all():
        return WarpPlan("direct")
    n = _TAPS[mode]
    ty, tx = STAGED_TILE
    oh, ow = int(size[0]), int(size[1])
    bw = bh = 0
    for h in hs:
        reach = max(abs(h[0]) * ow + abs(h[1]) * oh + abs(h[2]),
                    abs(h[3]) * ow + abs(h[4]) * oh + abs(h[5]), 1.0)
        slack = 16 * reach * 2.0 ** -24
        bw = max(bw, (int(abs(h[0]) * (tx - 1) + abs(h[1]) * (ty - 1) + slack) + n + 4) // 2 * 2)
        bh = max(bh, int(abs(h[3]) * (tx - 1) + abs(h[4]) * (ty - 1) + slack) + n + 1)
    if 4 * channels * bw * bh > STAGED_SMEM_BYTES:
        return WarpPlan("direct")
    pitch = bw + (8 - bw) % 32
    if 4 * channels * pitch * bh > STAGED_SMEM_BYTES:
        pitch = bw
    return WarpPlan("staged", (bh, pitch))


def _split(channels: int, mode: str, nearest_from):
    """(planes in `mode`, trailing nearest planes) of a launch."""
    if nearest_from is None or mode == "nearest":
        return channels, 0
    if not 0 < nearest_from <= channels:
        raise ValueError(f"nearest_from {nearest_from} outside 1 .. {channels}")
    return nearest_from, channels - nearest_from


def _launch(srcf, hinvs, out, mode, nearest_from, batched):
    """One launch of csrc/warp_affine.cu: the S maps of `hinvs` into `out`,
    a contiguous (S, C, OH, OW) float32 tensor."""
    build.check_cuda_tensor(srcf, "warp_affine source", 3)
    c, h, w = srcf.shape
    s, _, oh, ow = out.shape
    lead, trail = _split(c, mode, nearest_from)
    plan = plan_warp(hinvs, (oh, ow), mode, lead)   # the staged planes
    box_h, box_w = plan.box if plan.variant == "staged" else (0, 0)
    build.launch("warp_affine", "frtm_warp_affine_maps_f32", _ARGTYPES,
                 srcf.data_ptr(), out.data_ptr(), lead, trail, h, w, oh, ow,
                 (ctypes.c_float * (9 * s))(*hinvs.reshape(-1).tolist()), s,
                 MODES.index(mode), box_w, box_h, device=srcf.device,
                 variant=plan.variant + ("_batched" if batched else ""))


def _warp(src, hinvs, size, mode, nearest_from, batched):
    """(C, H, W) float32 or uint8 planes by S inverse maps to (S, C, OH, OW)
    in the source's dtype: the plain version on a CPU tensor, else one
    launch per MAX_MAPS maps, each writing its maps' slice of the output."""
    if mode not in MODES:
        raise ValueError(f"unknown warp mode: {mode}")
    if src.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"warp_affine: expected float32 or uint8, got {src.dtype}")
    srcf = src.float()
    if src.device.type == "cpu":
        out = warp_affine_batched_plain(srcf, hinvs, size, mode, nearest_from)
    else:
        out = torch.empty((len(hinvs), srcf.shape[0], int(size[0]), int(size[1])),
                          dtype=torch.float32, device=src.device)
        for i in range(0, len(hinvs), MAX_MAPS):
            _launch(srcf, hinvs[i:i + MAX_MAPS], out[i:i + MAX_MAPS], mode, nearest_from,
                    batched)
    return out.to(src.dtype)


def warp_affine(src: torch.Tensor, H, size, mode: str = "bicubic",
                nearest_from=None) -> torch.Tensor:
    """Warp (C, H, W) planes by the forward matrix H to (C, size[0], size[1]);
    planes from `nearest_from` on sampled nearest."""
    return _warp(src, inverse_coefficients(H)[None], size, mode, nearest_from, False)[0]


def warp_affine_batched(src: torch.Tensor, Hs, size, mode: str = "bicubic",
                        nearest_from=None) -> torch.Tensor:
    """Warp (C, H, W) planes by each of S forward matrices Hs to (S, C,
    size[0], size[1])."""
    hinvs = np.stack([inverse_coefficients(M) for M in Hs])
    return _warp(src, hinvs, size, mode, nearest_from, True)
