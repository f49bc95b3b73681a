"""frtm_tpu_torch.ops against frtm_tpu.ops on the same numpy inputs (the
port on the CPU, NCHW; the JAX package NHWC, transposed at the boundary)."""
from importlib import import_module

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from frtm_tpu_torch.device import resolve_device

# the packages' ops/__init__ re-export functions named like these modules
jconv = import_module("frtm_tpu.ops.conv")
jresize = import_module("frtm_tpu.ops.resize")
tconv = import_module("frtm_tpu_torch.ops.conv")
tresize = import_module("frtm_tpu_torch.ops.resize")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(13, 21), (4, 5), (9, 30)])
def test_resize_matches_jax(rng, mode, size):
    x = rng.randn(2, 9, 14, 3).astype(np.float32)
    want = np.asarray(jresize.resize(jnp.asarray(x), size, mode))
    got = nhwc(tresize.resize(nchw(x), size, mode))
    # measured max abs diff 4.8e-7 (matmul summation order)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_interpolate_and_adaptive_cat_match_jax(rng):
    a = rng.randn(1, 6, 8, 4).astype(np.float32)
    b = rng.randn(1, 3, 4, 2).astype(np.float32)
    want = np.asarray(jresize.adaptive_cat((jnp.asarray(a), jnp.asarray(b))))
    got = nhwc(tresize.adaptive_cat((nchw(a), nchw(b))))
    np.testing.assert_allclose(got, want, atol=1e-5)
    same = tresize.interpolate(nchw(a), (6, 8))
    np.testing.assert_array_equal(same.numpy(), nchw(a).numpy())


@pytest.mark.parametrize("k,stride,dilation,bias", [(1, 1, 1, False), (3, 1, 1, True),
                                                    (3, 2, 1, False), (7, 2, 1, False),
                                                    (3, 1, 2, True)])
def test_conv2d_matches_direct_jax_conv(rng, k, stride, dilation, bias):
    x = rng.randn(2, 11, 13, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32) * 0.2
    b = rng.randn(6).astype(np.float32) if bias else None
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                   None if b is None else jnp.asarray(b),
                                   stride=stride, dilation=dilation, tapsum=False))
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    got = nhwc(tconv.conv2d(nchw(x), wt, None if b is None else torch.from_numpy(b),
                            stride=stride, dilation=dilation))
    # measured max abs diff 1.9e-6
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_max_pool_and_batch_norm_match_jax(rng):
    x = rng.randn(2, 9, 11, 4).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(tconv.max_pool_3x3_s2(nchw(x))),
        np.asarray(jconv.max_pool_3x3_s2(jnp.asarray(x))))
    p = dict(scale=rng.rand(4).astype(np.float32) + 0.5, bias=rng.randn(4).astype(np.float32),
             mean=rng.randn(4).astype(np.float32), var=rng.rand(4).astype(np.float32) + 0.1)
    want = np.asarray(jconv.batch_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    got = nhwc(tconv.batch_norm(nchw(x), *(torch.from_numpy(p[k])
                                          for k in ("scale", "bias", "mean", "var"))))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(nhwc(tconv.relu(nchw(x))), np.maximum(x, 0))


def test_entry_points_default_to_cuda():
    """Without an explicit device="cpu" the port asks for the card."""
    from frtm_tpu_torch.config import DiscConfig
    from frtm_tpu_torch.models.discriminator import init_disc_params
    cfg = DiscConfig(in_channels=8, c_channels=4)
    assert resolve_device("cpu").type == "cpu"
    assert init_disc_params(cfg, torch.Generator(), "cpu").filter.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_disc_params(cfg, torch.Generator())
    else:
        assert resolve_device(None).type == "cuda"
        assert init_disc_params(cfg, torch.Generator()).filter.device.type == "cuda"
