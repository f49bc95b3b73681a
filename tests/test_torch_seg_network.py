"""The port's refinement decoder against frtm_tpu's seg_network_apply, with
weights from frtm_tpu's init_seg_network carried over; the image size makes
both pyrup stages, the final bilinear resize and the head conv run."""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.models import init_seg_network, seg_network_apply, seg_network_reduce
from frtm_tpu_torch.models.seg_network import SegNetwork
from frtm_tpu_torch.models.seg_network import seg_network_apply as torch_apply
from frtm_tpu_torch.models.seg_network import seg_network_reduce as torch_reduce
from frtm_tpu_torch.utils.convert import seg_network_from_jax

CH = {"layer5": 64, "layer4": 48, "layer3": 32, "layer2": 16}
SIZES = {"layer5": (2, 3), "layer4": (4, 6), "layer3": (8, 12), "layer2": (16, 24)}


def _inputs(rng, n=2):
    feats = {L: rng.randn(n, *SIZES[L], c).astype(np.float32) for L, c in CH.items()}
    scores = rng.randn(n, 4, 6, 1).astype(np.float32)
    return feats, scores


def _perturb_bn(tree, rng):
    for rrb in ("rrb1", "rrb2"):
        for p in tree[rrb].values():
            c = p["bn"]["mean"].shape[0]
            p["bn"] = dict(scale=rng.rand(c).astype(np.float32) + 0.5,
                           bias=rng.randn(c).astype(np.float32) * 0.1,
                           mean=rng.randn(c).astype(np.float32) * 0.1,
                           var=rng.rand(c).astype(np.float32) + 0.5)
    return tree


def _nets(rng):
    tree = jax.tree.map(np.asarray, init_seg_network(jax.random.PRNGKey(2), CH))
    tree = _perturb_bn(tree, rng)
    net = SegNetwork(CH)
    net.load_state_dict(seg_network_from_jax(tree))
    return jax.tree.map(jnp.asarray, tree), net.eval()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def test_seg_network_apply_matches_jax(rng):
    jparams, net = _nets(rng)
    feats, scores = _inputs(rng)
    image_size = (60, 90)      # pyrups give 64x96: the final resize is not a no-op
    want = np.asarray(seg_network_apply(jparams, jnp.asarray(scores),
                                        {L: jnp.asarray(v) for L, v in feats.items()},
                                        image_size))
    got = torch_apply(net, t(scores), {L: t(v) for L, v in feats.items()}, image_size)
    assert got.shape == (2, 1, 60, 90)
    got = got.permute(0, 2, 3, 1).numpy()
    # measured max abs diff 1.2e-7 against a logit scale of ~0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_seg_network_reduce_path_is_identical(rng):
    jparams, net = _nets(rng)
    feats, scores = _inputs(rng, n=1)
    tf = {L: t(v) for L, v in feats.items()}
    full = torch_apply(net, t(scores), tf, (64, 96))
    reduced = torch_apply(net, t(scores), None, (64, 96), reduced=torch_reduce(net, tf))
    assert torch.equal(full, reduced)
    jred = seg_network_reduce(jparams, {L: jnp.asarray(v) for L, v in feats.items()})
    for L, (h, hp) in torch_reduce(net, tf).items():
        np.testing.assert_allclose(h.permute(0, 2, 3, 1).numpy(), np.asarray(jred[L][0]),
                                   rtol=1e-4, atol=1e-5)
