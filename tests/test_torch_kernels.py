"""Each kernel's plain version (what a wrapper runs for a CPU tensor) against
the JAX function it ports and against its Pallas kernel in interpret mode.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from frtm_tpu.models.seg_network import pyr_up_bicubic as jax_pyrup
from frtm_tpu.ops.conv import conv2d as jax_conv2d
from frtm_tpu.ops.pallas.conv_small import conv3x3_cout1_pallas
from frtm_tpu.ops.pallas.pyrup import pyr_up_bicubic_pallas
from frtm_tpu.ops.pallas.warp import warp_affine_pallas
from frtm_tpu.ops.warp import warp_affine as jax_warp
from frtm_tpu_torch.ops.kernels import LAUNCHES, conv3x3_cout1, pyr_up_bicubic, warp_affine


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def chw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (2, 0, 1))))


def hwc(t):
    return np.transpose(t.numpy(), (1, 2, 0))


# --- kernel 1: pyrup --------------------------------------------------------

@pytest.mark.parametrize("shape,rb", [((1, 8, 12, 4), 4), ((2, 16, 10, 3), 8),
                                      ((1, 12, 16, 8), 5)])
def test_pyrup_plain_matches_jax_and_pallas(rng, shape, rb):
    from jax.experimental.pallas import tpu as pltpu
    x = rng.randn(*shape).astype(np.float32)
    got = nhwc(pyr_up_bicubic(nchw(x)))
    # same operation order as frtm_tpu's slice-sum form: measured bit-exact
    np.testing.assert_array_equal(got, np.asarray(jax_pyrup(jnp.asarray(x))))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pyr_up_bicubic_pallas(jnp.asarray(x), row_block=rb))
    np.testing.assert_allclose(got, want, atol=1e-5)


# --- kernel 2: conv3x3 to one channel ------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
def test_conv3x3_cout1_plain_matches_jax_and_pallas(rng, bias):
    x = rng.randn(2, 13, 17, 6).astype(np.float32)
    w = (rng.randn(3, 3, 6, 1) * 0.3).astype(np.float32)
    b = rng.randn(1).astype(np.float32) if bias else None
    jb = None if b is None else jnp.asarray(b)
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    got = nhwc(conv3x3_cout1(nchw(x), wt, None if b is None else torch.from_numpy(b)))
    direct = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), jb, tapsum=False))
    pallas = np.asarray(conv3x3_cout1_pallas(jnp.asarray(x), jnp.asarray(w), jb,
                                             row_block=5, interpret=True))
    # measured max abs diff 9.5e-7 (tap summation order)
    np.testing.assert_allclose(got, direct, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


# --- kernel 3: affine warp -------------------------------------------------------

def _mats():
    return {
        "rot": np.asarray([[0.94, -0.34, 3.2], [0.34, 0.94, -2.1], [0, 0, 1]], np.float32),
        "scale2x3": np.asarray([[1.3, 0.0, -1.5], [0.0, 0.8, 2.0]], np.float32),
        "oob": np.asarray([[1.0, 0.0, 14.0], [0.0, 1.0, -11.0], [0, 0, 1]], np.float32),
    }


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("mat", ["rot", "scale2x3", "oob"])
def test_warp_plain_matches_jax_and_pallas(rng, mode, mat):
    from jax.experimental.pallas import tpu as pltpu
    src = (rng.rand(20, 26, 3) * 255).astype(np.float32)
    H = _mats()[mat]
    got = hwc(warp_affine(chw(src), H, (18, 24), mode))
    want = np.asarray(jax_warp(jnp.asarray(src), H, (18, 24), mode=mode))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(warp_affine_pallas(jnp.asarray(src), H, (18, 24), mode=mode))
    # the inverse has JAX's float32 bits (inverse_coefficients), so the plain
    # warp equals frtm_tpu's; the Pallas kernel sums its taps in another
    # order: measured max abs diff 9.3e-4 on a 0..255 scale
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, pallas, atol=1e-3, rtol=0)


def test_warp_zero_border_and_uint8_labels(rng):
    src = (rng.rand(10, 12, 1) * 255).astype(np.float32)
    far = np.asarray([[1.0, 0.0, 100.0], [0.0, 1.0, 100.0], [0, 0, 1]], np.float32)
    assert np.all(warp_affine(chw(src), far, (10, 12), "bicubic").numpy() == 0.0)
    lbl = (rng.rand(10, 12, 1) > 0.5).astype(np.uint8)
    got = warp_affine(chw(lbl), _mats()["rot"], (7, 9), "nearest")
    assert got.dtype == torch.uint8
    want = np.asarray(jax_warp(jnp.asarray(lbl), _mats()["rot"], (7, 9), mode="nearest"))
    np.testing.assert_array_equal(hwc(got), want)


def test_cpu_tensors_never_count_as_launches(rng):
    before = dict(LAUNCHES)
    pyr_up_bicubic(torch.zeros(1, 1, 4, 4))
    conv3x3_cout1(torch.zeros(1, 2, 4, 4), torch.zeros(1, 2, 3, 3))
    warp_affine(torch.zeros(1, 4, 4), np.eye(3), (4, 4))
    assert LAUNCHES == before
