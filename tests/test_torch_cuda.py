"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Elsewhere every test skips. Tolerances: pyrup and the warp repeat the plain
version's float operations in the same order without FMA contraction, so they
must agree bit for bit; the head conv sums 9 * Cin products with FMA in
another order, so it is held to 5e-5 absolute at unit-scale inputs.
"""
import numpy as np
import pytest
import torch

from frtm_tpu_torch.device import resolve_device
from frtm_tpu_torch.ops.kernels import (LAUNCHES, conv3x3_cout1, conv3x3_cout1_plain,
                                        pyr_up_bicubic, pyr_up_bicubic_plain, warp_affine)
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


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("mat", sorted(_MATS))
def test_warp_kernel_is_bit_exact(gen, mode, mat):
    src = (torch.rand(4, 48, 85, generator=gen) * 255).cuda()
    want = warp_affine_plain(src, inverse_coefficients(_MATS[mat]), (40, 90), mode)
    before = LAUNCHES["warp_affine"]
    got = warp_affine(src, _MATS[mat], (40, 90), mode)
    assert LAUNCHES["warp_affine"] == before + 1
    assert torch.equal(got, want)


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
