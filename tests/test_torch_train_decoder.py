"""The port's decoder in training mode (`seg_network_apply(train_bn=True)`)
against frtm_tpu's, from the same weights: logits, the BatchNorm running
statistics chained over two frames, and the gradient of a loss with respect
to every refiner parameter (kernels 1 and 2 through their plain backward).

Two properties of the function bound the gradient comparison. A ReLU input
within float32 rounding of 0 may fall on either side of the kink in either
package, and one flipped element moves every upstream gradient by up to
1.4 % of its peak (measured: one element of 9216 at RRB2.layer3 on a
frame drawn from seed 5; seeds 5 to 11 give least ReLU inputs of 4e-8 to
1.2e-6 of their tensor's peak, and gradient gaps of 6e-6 to 1.1e-2). So the
test checks first that its frames (seed 9) keep every ReLU input of the
port's forward at least 1e-6 of its tensor's peak (about ten float32 ulps)
from 0, and only then holds gradients to 1e-4 of their peak. The bias of the conv before
each batch-statistics BatchNorm has an exact gradient of 0 (the BN removes
the mean); both sides give rounding noise there, held to 1e-4 of the
peak of the same conv's weight gradient."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.models import init_seg_network
from frtm_tpu.models.seg_network import apply_bn_updates as jax_apply_bn_updates
from frtm_tpu.models.seg_network import seg_network_apply as jax_apply
from frtm_tpu_torch.models.seg_network import SegNetwork, apply_bn_updates, seg_network_apply
from frtm_tpu_torch.utils.convert import seg_network_from_jax

CH = {"layer5": 64, "layer4": 48, "layer3": 32, "layer2": 16}
SIZES = {"layer5": (2, 3), "layer4": (4, 6), "layer3": (8, 12), "layer2": (16, 24)}
IMAGE = (60, 90)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def close_to_peak(got, want, rtol, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


SEED = 9


@pytest.fixture(scope="module")
def world():
    """Weights, two frames of inputs, a loss weighting, and the JAX side's
    results: per frame (logits, running stats) and the gradient of the
    two-frame loss."""
    rng = np.random.RandomState(SEED)
    tree = jax.tree.map(np.asarray, init_seg_network(jax.random.PRNGKey(3), CH))
    frames = []
    for _ in range(2):
        feats = {L: rng.randn(3, *SIZES[L], c).astype(np.float32) for L, c in CH.items()}
        frames.append((feats, rng.randn(3, 4, 6, 1).astype(np.float32),
                       rng.randn(3, *IMAGE, 1).astype(np.float32)))
    params = jax.tree.map(jnp.asarray, tree)

    def loss_fn(p):
        total, outs = 0.0, []
        for feats, scores, g in frames:
            logits, upd = jax_apply(p, jnp.asarray(scores),
                                    {L: jnp.asarray(v) for L, v in feats.items()}, IMAGE,
                                    train_bn=True)
            p = jax_apply_bn_updates(p, upd)
            total = total + jnp.sum(logits * jnp.asarray(g))
            outs.append((logits, upd))
        return total, outs

    (loss, outs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return dict(tree=tree, frames=frames, loss=float(loss),
                logits=[np.asarray(o[0]) for o in outs],
                stats=[jax.tree.map(np.asarray, o[1]) for o in outs],
                grads=seg_network_from_jax(jax.tree.map(np.asarray, grads)))


@pytest.fixture
def net(world):
    torch.set_num_threads(2)
    n = SegNetwork(CH)
    n.load_state_dict(seg_network_from_jax(world["tree"]))
    return n


def _run(net, world):
    total = 0.0
    logits, stats = [], []
    for feats, scores, g in world["frames"]:
        out, upd = seg_network_apply(net, t(scores), {L: t(v) for L, v in feats.items()},
                                     IMAGE, train_bn=True)
        apply_bn_updates(net, upd)
        total = total + (out * t(g)).sum()
        logits.append(out)
        stats.append(upd)
    return total, logits, stats


def test_train_mode_logits_and_chained_running_stats_match_jax(net, world):
    _, logits, stats = _run(net, world)
    for got, want in zip(logits, world["logits"]):
        assert got.requires_grad
        close_to_peak(got.detach().permute(0, 2, 3, 1).numpy(), want, 1e-4)
    for got, want in zip(stats, world["stats"]):
        assert set(got) == {(r.upper(), L) for r, L in want}
        for (rrb, L), (mean, var) in got.items():
            ref = want[(rrb.lower(), L)]
            close_to_peak(mean.numpy(), ref["mean"], 1e-5, f"{rrb} {L} mean")
            close_to_peak(var.numpy(), ref["var"], 1e-5, f"{rrb} {L} var")
    # the module holds the second frame's statistics, chained from the first's
    for (rrb, L), (mean, var) in stats[1].items():
        bn = getattr(net, rrb)[L].bblock[1]
        assert torch.equal(bn.running_mean, mean) and torch.equal(bn.running_var, var)
    assert not torch.equal(stats[0][("RRB1", "layer2")][0], stats[1][("RRB1", "layer2")][0])


def relu_margin(net, world, monkeypatch):
    """The least |ReLU input| / its tensor's peak over the port's forward."""
    import frtm_tpu_torch.models.seg_network as sn
    margins = []

    def record(x):
        margins.append(float(x.detach().abs().min() / x.detach().abs().max()))

    relu = sn.relu
    monkeypatch.setattr(sn, "relu", lambda x: (record(x), relu(x))[1])
    hooks = [m.register_forward_pre_hook(lambda m, args: record(args[0]))
             for m in net.modules() if isinstance(m, torch.nn.ReLU)]
    try:
        with torch.no_grad():
            _run(net, world)
    finally:
        for h in hooks:
            h.remove()
    net.load_state_dict(seg_network_from_jax(world["tree"]))
    return min(margins), len(margins)


def test_train_mode_gradients_match_jax(net, world, monkeypatch):
    margin, n_relus = relu_margin(net, world, monkeypatch)
    monkeypatch.undo()
    assert n_relus > 40 and margin > 1e-6, (margin, n_relus)
    total, _, _ = _run(net, world)
    np.testing.assert_allclose(float(total.detach()), world["loss"], rtol=1e-4)
    total.backward()
    names = 0
    grads = dict(net.named_parameters())
    for name, p in grads.items():
        assert p.grad is not None, name
        want = world["grads"][name].numpy()
        if name.endswith("bblock.0.bias"):
            scale = np.abs(world["grads"][name.replace("bias", "weight")].numpy()).max()
            assert np.abs(p.grad.numpy()).max() < 1e-4 * scale, name
            assert np.abs(want).max() < 1e-4 * scale, name
        else:
            close_to_peak(p.grad.numpy(), want, 1e-4, name)
        names += 1
    # every conv weight and bias, and BN weight and bias, of 4 layers + the head
    assert names == len([k for k in world["grads"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))])


def test_inference_calls_keep_running_statistics_and_record_nothing(net, world):
    feats, scores, _ = world["frames"][0]
    before = {k: v.clone() for k, v in net.state_dict().items()}
    net.train()     # the module flag is never read
    out = seg_network_apply(net, t(scores), {L: t(v) for L, v in feats.items()}, IMAGE)
    assert out.grad_fn is None
    net.eval()
    assert torch.equal(out, seg_network_apply(net, t(scores), {L: t(v) for L, v in feats.items()},
                                              IMAGE))
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
