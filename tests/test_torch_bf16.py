"""The port's bfloat16 modules against frtm_tpu's in bfloat16, on the same
inputs (made from a seed, rounded to bfloat16 once, handed to both): the
backbone, the decoder, and the plain versions of kernels 1 and 2. The
trackers are in test_torch_bf16_trackers.py.

Two bfloat16 computations of one function agree no better than bfloat16
allows, and how well that is depends on the function. So every bound here is
stated beside a yardstick measured in the same test: the JAX package's own
bfloat16-to-float32 gap on the same input.

  backbone (rn18, 2 frames 64x96, all five maps): the port's bfloat16 maps
    lie within 0.75 of that gap of JAX's bfloat16 maps (max abs; measured at
    most 0.34, layer4) and within 0.5 of it in rms (measured at most 0.31,
    layer5).
  decoder (seg_network_apply, 60x90 logits): both packages round in different
    places, by design in kernels 1 and 2 (below), so their two results are
    two noisy copies of the float32 one. Bound: within 1.5 of the gap of
    JAX's bfloat16 logits (measured 1.03 max abs, 1.08 rms), and the port no
    further from JAX's float32 logits than JAX's own bfloat16 ones are
    (measured 0.75 max abs, 0.72 rms).
  kernels 1 and 2, plain versions: the port computes in float32 on the
    upcast input and rounds once; the JAX functions in bfloat16 round more
    often (`pyr_up_bicubic` and its Pallas kernel in interpret mode, which
    agree bit for bit here, after every product and sum; XLA's convolution
    and `conv3x3_cout1_pallas` in interpret mode once more where a bias is
    added). In units of one bfloat16 ulp at the output's peak (2^-8 of it):
    the port lies within 1 ulp of the float32 function (measured at most 0.79
    pyrup, 0.70 head conv: one rounding), the JAX functions within 2.37 and
    0.93, and the two apart by at most the sum (bound: JAX's own gap + 1 ulp;
    measured 2.51 against 3.37 for pyrup, 1.26 against 1.93 for the head conv
    with its bias). Without a bias the port's head conv equals the Pallas
    kernel bit for bit: that one, too, accumulates in float32 and rounds once.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from frtm_tpu.models import extract_features, init_resnet, seg_network_apply
from frtm_tpu.models.seg_network import pyr_up_bicubic
from frtm_tpu.ops.pallas.conv_small import conv3x3_cout1_pallas
from frtm_tpu.ops.pallas.pyrup import pyr_up_bicubic_pallas
from frtm_tpu_torch.models.resnet import ResNet
from frtm_tpu_torch.models.seg_network import seg_network_apply as torch_apply
from frtm_tpu_torch.ops.conv import compute_copy
from frtm_tpu_torch.ops.kernels import (conv3x3_cout1, conv3x3_cout1_plain, pyr_up_bicubic as
                                        torch_pyr_up, pyr_up_bicubic_plain)
from frtm_tpu_torch.utils.convert import resnet_from_jax
from test_torch_resnet import _perturb_bn
from test_torch_seg_network import _inputs, _nets

torch.set_num_threads(2)
BF = jnp.bfloat16


def _bf(a):
    return jnp.asarray(a).astype(BF)


def _f32(a):
    return np.array(a.astype(jnp.float32))


def _nchw_bf16(a):
    """A bfloat16 NHWC JAX array as a bfloat16 NCHW tensor, value for value."""
    return torch.from_numpy(_f32(a)).permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def test_backbone_in_bfloat16_matches_jax(rng):
    tree = _perturb_bn(jax.tree.map(np.asarray, init_resnet(jax.random.PRNGKey(3), "resnet18")),
                       rng)
    images = (rng.rand(2, 64, 96, 3) * 255).astype(np.uint8)
    jparams = jax.tree.map(jnp.asarray, tree)
    want32 = extract_features(jparams, jnp.asarray(images), "resnet18")
    want16 = extract_features(jparams, jnp.asarray(images), "resnet18", dtype=BF, out_dtype=BF)

    net = ResNet("resnet18")
    net.load_state_dict(resnet_from_jax(tree))
    net16 = compute_copy(net, torch.bfloat16)
    assert compute_copy(net, torch.float32) is net and net16 is not net
    assert net16.conv1.weight.dtype == torch.bfloat16 and net.conv1.weight.dtype == torch.float32
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    got = net16.extract_features(x, out_dtype=torch.bfloat16)
    emitted32 = net16.extract_features(x, output_layers=["layer4"])
    assert emitted32["layer4"].dtype == torch.float32       # computes in bfloat16, emits float32
    assert torch.equal(emitted32["layer4"], got["layer4"].float())
    for L in sorted(want32):
        assert got[L].dtype == torch.bfloat16 and want16[L].dtype == BF
        w32, w16, g = np.asarray(want32[L]), _f32(want16[L]), _nhwc(got[L])
        own_max, own_rms = np.abs(w16 - w32).max(), _rms(w16 - w32)
        assert own_max > 1e-3 * np.abs(w32).max()           # bfloat16 did run in JAX
        assert np.abs(g - w16).max() <= 0.75 * own_max, (L, np.abs(g - w16).max() / own_max)
        assert _rms(g - w16) <= 0.5 * own_rms, (L, _rms(g - w16) / own_rms)


def test_decoder_in_bfloat16_matches_jax(rng):
    jparams, net = _nets(rng)
    feats, scores = _inputs(rng)
    size = (60, 90)             # pyrups give 64x96: the final resize is not a no-op
    scores16 = _bf(scores)
    feats16 = {L: _bf(v) for L, v in feats.items()}
    want32 = np.asarray(seg_network_apply(jparams, jnp.asarray(scores),
                                          {L: jnp.asarray(v) for L, v in feats.items()}, size))
    jparams16 = jax.tree.map(
        lambda a: a.astype(BF) if jnp.issubdtype(a.dtype, jnp.floating) else a, jparams)
    want16 = seg_network_apply(jparams16, scores16, feats16, size)
    assert want16.dtype == BF
    want16 = _f32(want16)

    net16 = compute_copy(net, torch.bfloat16)
    got = torch_apply(net16, _nchw_bf16(scores16), {L: _nchw_bf16(v) for L, v in feats16.items()},
                      size)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 60, 90)
    g = _nhwc(got)
    own_max, own_rms = np.abs(want16 - want32).max(), _rms(want16 - want32)
    assert own_max > 1e-3 * np.abs(want32).max()
    assert np.abs(g - want16).max() <= 1.5 * own_max, np.abs(g - want16).max() / own_max
    assert _rms(g - want16) <= 1.5 * own_rms, _rms(g - want16) / own_rms
    assert np.abs(g - want32).max() <= own_max, np.abs(g - want32).max() / own_max
    assert _rms(g - want32) <= own_rms, _rms(g - want32) / own_rms


@pytest.mark.parametrize("shape", [(2, 12, 17, 8), (1, 9, 16, 3), (1, 5, 7, 2)])
def test_pyrup_plain_in_bfloat16_matches_jax(rng, shape):
    x16 = _bf(rng.randn(*shape).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        pallas = pyr_up_bicubic_pallas(x16)
    xla = pyr_up_bicubic(x16)
    assert pallas.dtype == xla.dtype == BF
    want32 = np.asarray(pyr_up_bicubic(x16.astype(jnp.float32)))
    tx = _nchw_bf16(x16)
    got = pyr_up_bicubic_plain(tx)
    assert got.dtype == torch.bfloat16 and got.shape == (shape[0], shape[3], 2 * shape[1],
                                                         2 * shape[2])
    # the wrapper takes the plain version on a CPU tensor, and that is the
    # float32 plain version on the upcast input, rounded once
    assert torch.equal(torch_pyr_up(tx), got)
    assert torch.equal(got, pyr_up_bicubic_plain(tx.float()).to(torch.bfloat16))
    g = _nhwc(got)
    ulp = np.abs(want32).max() * 2.0 ** -8
    assert np.abs(g - want32).max() <= 1.0 * ulp, np.abs(g - want32).max() / ulp
    for theirs in (_f32(pallas), _f32(xla)):
        own = np.abs(theirs - want32).max()
        assert np.abs(g - theirs).max() <= own + ulp, (np.abs(g - theirs).max() / ulp, own / ulp)


@pytest.mark.parametrize("bias", [True, False])
def test_head_conv_plain_in_bfloat16_matches_jax(rng, bias):
    x16 = _bf(np.maximum(rng.randn(2, 32, 54, 16), 0).astype(np.float32))
    k16 = _bf((rng.randn(3, 3, 16, 1) * 0.1).astype(np.float32))
    b16 = _bf(rng.randn(1).astype(np.float32)) if bias else None
    pallas = conv3x3_cout1_pallas(x16, k16, b16, interpret=True)
    dn = lax.conv_dimension_numbers(x16.shape, k16.shape, ("NHWC", "HWIO", "NHWC"))
    conv = lambda x, k: lax.conv_general_dilated(x, k, (1, 1), [(1, 1), (1, 1)],
                                                 dimension_numbers=dn)
    xla = conv(x16, k16) + (b16 if bias else 0)
    assert pallas.dtype == BF and xla.dtype == BF
    want32 = np.asarray(conv(x16.astype(jnp.float32), k16.astype(jnp.float32))) \
        + (_f32(b16) if bias else 0)
    tx = _nchw_bf16(x16)
    tw = torch.from_numpy(_f32(k16)).permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
    tb = torch.from_numpy(_f32(b16)).to(torch.bfloat16) if bias else None
    got = conv3x3_cout1_plain(tx, tw, tb)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 32, 54)
    assert torch.equal(conv3x3_cout1(tx, tw, tb), got)
    g = _nhwc(got)
    ulp = np.abs(want32).max() * 2.0 ** -8
    assert np.abs(g - want32).max() <= 1.0 * ulp, np.abs(g - want32).max() / ulp
    for theirs in (_f32(pallas), _f32(xla)):
        own = np.abs(theirs - want32).max()
        assert np.abs(g - theirs).max() <= own + ulp, (np.abs(g - theirs).max() / ulp, own / ulp)
    with pytest.raises(TypeError):          # one element type for input, weight and bias
        conv3x3_cout1(tx, tw.float(), tb)
    with pytest.raises(TypeError):
        torch_pyr_up(tx.to(torch.float16))
