"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Elsewhere every test skips. Tolerances: pyrup and the warp repeat the plain
version's float operations in the same order without FMA contraction, so they
must agree bit for bit; the head conv sums 9 * Cin products with FMA in
another order, so it is held to 5e-5 absolute at unit-scale inputs.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from frtm_tpu_torch.device import resolve_device
from frtm_tpu_torch.ops.kernels import (LAUNCHES, VARIANTS, conv3x3_cout1,
                                        conv3x3_cout1_plain, pyr_up_bicubic,
                                        pyr_up_bicubic_plain, warp_affine)
from frtm_tpu_torch.ops.warp import inverse_coefficients, warp_affine_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    resolve_device("cuda")
    return torch.Generator().manual_seed(0)


# the main path's two stages and N=8 (the fused tracker's decode window);
# odd W (2W = 2 mod 4: 8-byte stores); 2W just below, at and above the
# 128-column tile (W = 63, 64, 65, 66); H below and just above the
# 32-row-pair tile (H = 5, 32, 33); a single pixel
@pytest.mark.parametrize("shape", [(1, 32, 120, 214), (1, 16, 240, 428), (8, 32, 120, 214),
                                   (2, 3, 7, 5), (1, 1, 1, 1), (1, 2, 9, 131),
                                   (1, 3, 5, 63), (1, 3, 32, 64), (1, 3, 17, 65),
                                   (2, 2, 33, 66)])
def test_pyrup_kernel_is_bit_exact(gen, shape):
    x = torch.randn(shape, generator=gen).cuda()
    before = LAUNCHES["pyrup"]
    got = pyr_up_bicubic(x)
    assert LAUNCHES["pyrup"] == before + 1
    assert torch.equal(got, pyr_up_bicubic_plain(x))


# the head conv at N=1 and N=8; Cin 1, 3, 16 and 64; rows only 4-byte
# aligned (W = 129, 127: 4-byte copies); H below (4, 5, 7, 9) and just above
# (17) the 16-row tile
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(1, 16, 480, 854), (8, 16, 480, 854), (2, 3, 5, 129),
                                   (1, 64, 17, 33), (1, 1, 9, 130), (3, 1, 4, 7),
                                   (1, 3, 7, 127)])
def test_conv3x3_cout1_kernel_matches_plain(gen, shape, bias):
    x = torch.randn(shape, generator=gen).cuda()
    w = (torch.rand(1, shape[1], 3, 3, generator=gen) * 0.2 - 0.1).cuda()
    b = torch.randn(1, generator=gen).cuda() if bias else None
    torch.testing.assert_close(conv3x3_cout1(x, w, b), conv3x3_cout1_plain(x, w, b),
                               atol=5e-5, rtol=0)


_MATS = {
    "rot": np.asarray([[0.94, -0.34, 3.2], [0.34, 0.94, -2.1], [0, 0, 1]], np.float32),
    "scale2x3": np.asarray([[1.3, 0.0, -1.5], [0.0, 0.8, 2.0]], np.float32),
    "projective": np.asarray([[1.0, 0.1, 2.0], [0.05, 0.9, -1.0], [1e-3, -2e-3, 1.0]],
                             np.float32),
    "off_frame": np.asarray([[1.0, 0.0, 500.0], [0.0, 1.0, 500.0], [0, 0, 1]], np.float32),
}


def _warp_checked(src, M, size, mode, variant):
    """The kernel's warp, checked to launch once, by `variant`, and to equal
    the plain version bit for bit."""
    want = warp_affine_plain(src, inverse_coefficients(M), size, mode)
    before, vbefore = LAUNCHES["warp_affine"], dict(VARIANTS["warp_affine"])
    got = warp_affine(src, M, size, mode)
    assert LAUNCHES["warp_affine"] == before + 1
    assert VARIANTS["warp_affine"][variant] == vbefore[variant] + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("mat", sorted(_MATS))
def test_warp_kernel_is_bit_exact(gen, mode, mat):
    src = (torch.rand(4, 48, 85, generator=gen) * 255).cuda()
    _warp_checked(src, _MATS[mat], (40, 90), mode,
                  "direct" if mat == "projective" else "staged")


def _affine(angle, scale, flip=False, skew=0.0, to=(120.0, 100.0), frm=(160.0, 120.0)):
    """The augmenter's map: the source point `frm` to the output point `to`,
    with mirror, scale, rotation (degrees) and skew about it."""
    a = np.deg2rad(angle)
    return (np.array([[1, 0, to[0]], [0, 1, to[1]], [0, 0, 1]])
            @ np.array([[1, skew, 0], [skew, 1, 0], [0, 0, 1]])
            @ np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]])
            @ np.diag([-scale if flip else scale, scale, 1.0])
            @ np.array([[1, 0, -frm[0]], [0, 1, -frm[1]], [0, 0, 1]]))


# (channels, map, output size, variant) on a 240x320 source: inverse step 2
# at 45 degrees (the augmenter's worst footprint), mirrors and skew, output
# boxes of one pixel, 3x5 and odd widths (ragged tiles), C = 1, 2, 3, 4,
# 480x854 outputs rotated (most tiles border) and axis-aligned (the eval
# background's map), footprints partly and fully off the frame, and a
# shrink by 5, or 40 channels, whose boxes exceed the shared-memory budget
_WARPS = {
    "step2_45deg": (4, _affine(45, 0.5), (200, 240), "staged"),
    "step2_skew_flip": (4, _affine(-45, 0.5, flip=True, skew=0.1), (200, 240), "staged"),
    "flip": (3, _affine(20, 1.3, flip=True), (200, 240), "staged"),
    "skew": (3, _affine(-30, 0.7, skew=0.1), (131, 97), "staged"),
    "one_pixel": (4, _affine(10, 1.5), (1, 1), "staged"),
    "3x5": (3, _affine(30, 2.0), (3, 5), "staged"),
    "odd_width": (1, _affine(-10, 1.0), (37, 33), "staged"),
    "c1": (1, _affine(5, 1.2), (480, 854), "staged"),
    "axis_aligned": (3, _affine(0, 1.2), (480, 854), "staged"),
    "c2": (2, _affine(-60, 1.7), (120, 150), "staged"),
    "partly_off": (3, _affine(60, 0.7, to=(50.0, 50.0), frm=(10.0, 10.0)), (100, 130),
                   "staged"),
    "fully_off": (4, _affine(0, 1.0, to=(0.0, 0.0), frm=(900.0, 900.0)), (64, 96), "staged"),
    "over_budget": (3, _affine(45, 0.2), (200, 240), "direct"),
    "channels_over_budget": (40, _affine(10, 1.0), (64, 96), "direct"),
}


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("case", sorted(_WARPS))
def test_warp_variants_are_bit_exact(gen, mode, case):
    c, M, size, variant = _WARPS[case]
    src = (torch.rand(c, 240, 320, generator=gen) * 255).cuda()
    _warp_checked(src, M, size, mode, variant)


_OVER_PLAN = """
import ctypes, torch
from frtm_tpu_torch.ops.kernels import build
from frtm_tpu_torch.ops.kernels.warp_affine import _ARGTYPES
src = torch.rand(1, 64, 64, device="cuda")
out = torch.empty(1, 32, 32, device="cuda")
fn = build.library("warp_affine").frtm_warp_affine_staged_f32
fn.argtypes = _ARGTYPES + [ctypes.c_int] * 3 + [ctypes.c_void_p]
identity = (ctypes.c_float * 9)(1, 0, 0, 0, 1, 0, 0, 0, 1)
# a planned box of 2x2 against the identity's ~20x38 tile boxes
assert fn(src.data_ptr(), out.data_ptr(), 1, 64, 64, 32, 32, identity, 2, 2, 2, 0, None) == 0
try:
    torch.cuda.synchronize()
    print("no error")
except RuntimeError as e:
    print("launch failed:", e)
"""


def test_staged_warp_fails_on_a_box_over_its_plan(gen):
    """A tile whose source box exceeds the planned box stops the staged
    launch with an error; nothing stands in for it. In a child process,
    since the error leaves that process's CUDA context unusable."""
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", _OVER_PLAN], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert "launch failed" in r.stdout, r.stdout + r.stderr


def test_warp_kernel_keeps_uint8_labels(gen):
    lbl = (torch.rand(1, 48, 85, generator=gen) > 0.5).to(torch.uint8).cuda()
    got = warp_affine(lbl, _MATS["rot"], (30, 40), "nearest")
    assert got.dtype == torch.uint8
    assert torch.equal(got.cpu(), warp_affine(lbl.cpu(), _MATS["rot"], (30, 40), "nearest"))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(1, 4, 8, 10, generator=gen).cuda()
    with pytest.raises(TypeError):
        pyr_up_bicubic(x.double())
    with pytest.raises(ValueError):
        pyr_up_bicubic(x.transpose(2, 3))
    with pytest.raises(ValueError):
        conv3x3_cout1(x, torch.zeros(1, 3, 3, 3, device="cuda"))
    with pytest.raises(RuntimeError):   # weights and halos beyond 48 KB of shared memory
        conv3x3_cout1(torch.zeros(1, 926, 4, 4, device="cuda"),
                      torch.zeros(1, 926, 3, 3, device="cuda"))
    with pytest.raises(ValueError):
        warp_affine(x[0], np.eye(2), (8, 10))
