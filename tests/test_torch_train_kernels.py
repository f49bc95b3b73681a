"""The plain backward of kernels 1 and 2 (what their autograd Functions run
on a CPU tensor) against jax.vjp of the JAX decoder's ops, which is the
gradient the JAX trainer takes. The CUDA backward kernels are held against
these plain versions on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.models.seg_network import pyr_up_bicubic as jax_pyrup
from frtm_tpu.ops.conv import conv2d as jax_conv2d
from frtm_tpu_torch.ops.kernels import (LAUNCHES, conv3x3_cout1, conv3x3_cout1_input_grad,
                                        conv3x3_cout1_weight_grad, pyr_up_bicubic,
                                        pyr_up_bicubic_backward)
from frtm_tpu_torch.ops.kernels.pyrup import FOLD_FIRST, FOLD_LAST, PYRDOWN_TAPS


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def close_to_peak(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


# (N, H, W, C): H and W of 1 and 2 fold every padded row onto one source row
@pytest.mark.parametrize("shape", [(2, 7, 5, 3), (1, 1, 1, 2), (1, 2, 9, 1), (2, 12, 16, 8)])
def test_pyrup_backward_plain_matches_jax_vjp(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    gy = rng.randn(shape[0], 2 * shape[1], 2 * shape[2], shape[3]).astype(np.float32)
    _, vjp = jax.vjp(jax_pyrup, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(gy))
    got = pyr_up_bicubic_backward(nchw(gy), nchw(x).shape)
    close_to_peak(nhwc(got), np.asarray(want), 1e-5)
    # and through the autograd Function, as the decoder takes it
    xt = nchw(x).requires_grad_()
    pyr_up_bicubic(xt).backward(nchw(gy))
    assert torch.equal(xt.grad, got)


# one compiled program per shape: op by op, JAX compiles each op of the decoder
_jax_pyrup_vjp = jax.jit(lambda x, gy: jax.vjp(jax_pyrup, x)[1](gy)[0])


def pyrdown_gather(gy, axis):
    """csrc/pyrup_bwd.cu's formula along one axis of a float32 array: at
    index h, the stride-2 8-tap filter PYRDOWN_TAPS over gy[2h - 3 ..] (zero
    outside gy), with the folded padded rows FOLD_FIRST added into the taps
    of index 0 and FOLD_LAST into those of index n - 1."""
    f, first, last = (np.float32(t) for t in (PYRDOWN_TAPS, FOLD_FIRST, FOLD_LAST))
    g = np.moveaxis(gy, axis, -1)
    n = g.shape[-1] // 2
    zeros = np.zeros(g.shape[:-1] + (3,), np.float32)
    p = np.concatenate([zeros, g, zeros], -1)        # p[2h + i] = gy[2h - 3 + i]
    taps = np.tile(f, (n, 1))
    taps[0, 3:6] += first                            # gy[0], gy[1], gy[2]
    taps[n - 1, 2:5] += last                         # gy[2n - 3], gy[2n - 2], gy[2n - 1]
    out = taps[:, 0] * p[..., 0:2 * n:2]
    for i in range(1, 8):
        out = out + taps[:, i] * p[..., i:i + 2 * n:2]
    return np.moveaxis(out, -1, axis)


# (N, H, W, C): every H and W from 1 (both folds onto one index) to 5 (the
# first size with an index that neither fold nor the zero border reaches),
# an odd W of 11, and a training-like plane
@pytest.mark.parametrize("shape", [(1, h, w, 2) for h in range(1, 6) for w in range(1, 6)]
                         + [(1, 6, 11, 3), (2, 12, 16, 8)])
def test_pyrup_backward_kernel_formula_matches_jax_vjp(rng, shape):
    """The backward kernel cannot run here; its formula and tables can."""
    x = rng.randn(*shape).astype(np.float32)
    gy = rng.randn(shape[0], 2 * shape[1], 2 * shape[2], shape[3]).astype(np.float32)
    want = _jax_pyrup_vjp(jnp.asarray(x), jnp.asarray(gy))
    close_to_peak(pyrdown_gather(pyrdown_gather(gy, 1), 2), np.asarray(want), 1e-5)


@pytest.mark.parametrize("shape", [(2, 13, 17, 6), (1, 1, 1, 1), (3, 5, 4, 32)])
def test_head_conv_backward_plain_matches_jax_vjp(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[3], 1) * 0.3).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    gy = rng.randn(*shape[:3], 1).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, b: jax_conv2d(x, w, b, tapsum=False),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = (np.asarray(g) for g in vjp(jnp.asarray(gy)))
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
    dx = conv3x3_cout1_input_grad(nchw(gy), wt, nchw(x).shape)
    dw, db = conv3x3_cout1_weight_grad(nchw(x), nchw(gy))
    close_to_peak(nhwc(dx), jdx, 1e-5)
    close_to_peak(np.transpose(dw.numpy(), (2, 3, 1, 0)), jdw, 1e-5)
    close_to_peak(db.numpy(), jdb, 1e-5)
    # through the autograd Function: the same values
    xt, wr, br = nchw(x).requires_grad_(), wt.clone().requires_grad_(), \
        torch.from_numpy(b).requires_grad_()
    conv3x3_cout1(xt, wr, br).backward(nchw(gy))
    assert torch.equal(xt.grad, dx) and torch.equal(wr.grad, dw) and torch.equal(br.grad, db)


def test_inference_records_no_graph_and_cpu_backward_counts_no_launch():
    x = torch.randn(1, 2, 4, 5, requires_grad=True)
    w = torch.randn(1, 2, 3, 3, requires_grad=True)
    with torch.no_grad():
        assert pyr_up_bicubic(x).grad_fn is None
        assert conv3x3_cout1(x, w).grad_fn is None
    assert pyr_up_bicubic(x.detach()).grad_fn is None
    before = dict(LAUNCHES)
    conv3x3_cout1(pyr_up_bicubic(x), torch.randn(1, 2, 3, 3, requires_grad=True)).sum().backward()
    assert LAUNCHES == before
    assert x.grad is not None and x.grad.shape == x.shape


def test_bf16_backward_raises():
    x = torch.randn(1, 2, 4, 5).bfloat16().requires_grad_()
    with pytest.raises(TypeError):
        pyr_up_bicubic(x).sum().backward()
    w = torch.randn(1, 2, 3, 3).bfloat16().requires_grad_()
    with pytest.raises(TypeError):
        conv3x3_cout1(x, w).sum().backward()
