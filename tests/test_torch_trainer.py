"""The port's trainer (runtime/trainer.py) against frtm_tpu's on the same
weights and data: one masked train step (loss, accuracy, gradients, running
statistics, the updated refiner), the cold-start target models and the cache
both packages read, the padded batches under equal seeds, a 3-epoch
synthetic run whose loss falls as frtm_tpu's does, checkpoints and resume,
and the `train` entry point's surface. rn18 at 64x96 (96x128 for the run),
batch 4, three frames per sample; JAX's results are computed once per
module."""
import contextlib
import io
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.config import eval_config as jax_eval_config
from frtm_tpu.data.training_datasets import SampleSpec as JaxSpec
from frtm_tpu.data.training_datasets import SyntheticTrainingDataset as JaxSynthetic
from frtm_tpu.models import init_resnet, init_seg_network, resnet_out_channels
from frtm_tpu.models.augmenter import ImageAugmenter as JaxAugmenter
from frtm_tpu.models.discriminator import init_disc_params
from frtm_tpu.runtime import trainer as jt
from frtm_tpu_torch.config import eval_config
from frtm_tpu_torch.data.training_datasets import SampleSpec, SyntheticTrainingDataset
from frtm_tpu_torch.models.discriminator import DiscParams
from frtm_tpu_torch.models.resnet import ResNet
from frtm_tpu_torch.models.seg_network import SegNetwork
from frtm_tpu_torch.runtime.trainer import (AMSGrad, TModelCache, Trainer, TrainerModel,
                                            iou_accuracy)
from frtm_tpu_torch.utils.convert import (disc_params_from_jax, disc_params_to_jax,
                                          resnet_from_jax, seg_network_from_jax)

ARCH = "resnet18"
ROOT = Path(__file__).resolve().parents[1]
BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _tiny(cfg):
    return replace(cfg, disc=replace(
        cfg.disc, c_channels=16, init_iters=(3, 5), update_iters=(3,), memory_size=8,
        filter_reg=(1e-5, 1e-4), precond=(1e-5, 1e-4), cg_forgetting_rate=75,
        pixel_weighting_method="none"))


JCFG = _tiny(jax_eval_config(ARCH, fast=True, num_aug=3))
TCFG = _tiny(eval_config(ARCH, fast=True, num_aug=3))
CH = {L: c for L, c in resnet_out_channels(ARCH).items() if L in JCFG.refnet_layers}


@pytest.fixture(scope="module")
def weights():
    torch.set_num_threads(2)
    bb = init_resnet(jax.random.PRNGKey(1), ARCH)
    ref = init_seg_network(jax.random.PRNGKey(2), CH, use_bn=True)
    p0 = init_disc_params(jax.random.PRNGKey(0), JCFG.disc)
    return bb, ref, p0


def port_model(weights, cache=None):
    bb, ref, p0 = weights
    tb = ResNet(ARCH)
    tb.load_state_dict(resnet_from_jax(jax.tree.map(np.asarray, bb)))
    tr = SegNetwork(CH)
    tr.load_state_dict(seg_network_from_jax(jax.tree.map(np.asarray, ref)))
    return TrainerModel(TCFG, tb, tr, cache or TModelCache(None, enable=False), device="cpu",
                        disc_params0=disc_params_from_jax(np.asarray(p0.project),
                                                          np.asarray(p0.filter)))


def jax_model(weights, cache=None):
    bb, ref, _ = weights
    model = jt.TrainerModel(JCFG, bb, ref, cache or jt.TModelCache(None, enable=False))
    # the warps of kernel 3's float math, which the port's augmenter repeats
    model.augmenter = JaxAugmenter(JCFG.aug_params, backend="xla")
    return model


def batch(n, size, seed=0):
    items = [JaxSynthetic(n_samples=n, size=size, sample_size=3, seed=seed)[i] for i in range(n)]
    images = np.stack([np.stack([it[0][t] for it in items]) for t in range(3)])
    labels = np.stack([np.stack([it[1][t] for it in items]) for t in range(3)])
    return images, labels, [it[2] for it in items]


def to_port(disc_batch):
    """JAX DiscParams stacked over the batch -> the port's."""
    ps = [disc_params_from_jax(np.asarray(disc_batch.project[i]), np.asarray(disc_batch.filter[i]))
          for i in range(disc_batch.project.shape[0])]
    return DiscParams(torch.stack([p.project for p in ps]), torch.stack([p.filter for p in ps]))


def close_to_peak(got, want, rtol, what=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.fixture(scope="module")
def step_world(weights, tmp_path_factory):
    """Cold-start target models built by both packages (each writing its own
    cache), then one masked train step of frtm_tpu on JAX's target models:
    with optax.sgd(1.0) its update is the gradient."""
    images, labels, enc = batch(4, (64, 96))
    specs = JaxSpec.from_encoded(enc)
    jdir, tdir = tmp_path_factory.mktemp("jax_cache"), tmp_path_factory.mktemp("port_cache")
    jm = jax_model(weights, jt.TModelCache(jdir))
    jdisc, jhits = jm.build_disc_batch(images[0], labels[0], specs)
    tm = port_model(weights, TModelCache(tdir))
    tdisc, thits = tm.build_disc_batch(images[0], labels[0], SampleSpec.from_encoded(enc))
    mask = np.asarray([1, 1, 1, 0], np.float32)
    tx = optax.sgd(1.0)
    ref = weights[1]
    new, _, stats = jax.jit(lambda r, s, bb, d, i, l, m: jm._train_step(r, s, bb, d, i, l, m, tx))(
        ref, tx.init(ref), weights[0], jdisc, jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(mask))
    old_sd = seg_network_from_jax(jax.tree.map(np.asarray, ref))
    new_sd = seg_network_from_jax(jax.tree.map(np.asarray, new))
    grads = {k: old_sd[k] - new_sd[k] for k in old_sd if not k.endswith(BN_STATS)}
    # the real optimizer's first step on those gradients
    opt = jt.make_optimizer(1e-3, 1e-5)
    jgrad_tree = jax.tree.map(lambda a, b: a - b, ref, new)
    updates, _ = opt.update(jgrad_tree, opt.init(ref), ref)
    stepped = seg_network_from_jax(jax.tree.map(np.asarray, optax.apply_updates(ref, updates)))
    return dict(images=images, labels=labels, enc=enc, mask=mask, jdisc=jdisc, jhits=jhits,
                tdisc=tdisc, thits=thits, jdir=jdir, tdir=tdir,
                loss=float(stats["stats/loss"]), acc=float(stats["stats/accuracy"]),
                grads=grads, bn=new_sd, stepped=stepped)


def test_iou_accuracy_conventions():
    a, z = torch.ones(1, 8, 8), torch.zeros(1, 8, 8)
    assert float(iou_accuracy(a, a)[0]) == 1.0
    assert float(iou_accuracy(z, z)[0]) == 1.0     # 0 / 0 -> 1
    assert float(iou_accuracy(a, z)[0]) == 0.0
    rng = np.random.RandomState(0)
    p, g = rng.rand(3, 9, 11).astype(np.float32), rng.rand(3, 9, 11).astype(np.float32)
    np.testing.assert_array_equal(iou_accuracy(torch.from_numpy(p), torch.from_numpy(g)).numpy(),
                                  np.asarray(jt.iou_accuracy(jnp.asarray(p), jnp.asarray(g))))


def test_cold_start_target_models_match_jax(step_world):
    w = step_world
    assert w.get("thits") == w["jhits"] == 0
    jf = np.asarray(w["jdisc"].filter)                 # (B, 3, 3, c, 1)
    tf = np.transpose(w["tdisc"].filter.numpy(), (0, 3, 4, 2, 1))
    jp = np.asarray(w["jdisc"].project)
    tp = np.transpose(w["tdisc"].project.numpy(), (0, 3, 4, 2, 1))
    for i in range(jf.shape[0]):
        # the GN-CG init is ill-conditioned at test size (ROADMAP.md
        # section 4, F5): filters within 1e-2 of their peak
        close_to_peak(tf[i], jf[i], 1e-2, f"filter {i}")
        close_to_peak(tp[i], jp[i], 1e-2, f"project {i}")


def test_cache_files_read_both_ways(step_world):
    w = step_world
    specs = SampleSpec.from_encoded(w["enc"])
    for i, spec in enumerate(specs):
        # the port reads what frtm_tpu wrote, value for value ...
        got = TModelCache(w["jdir"]).load(spec, "layer4")
        want = disc_params_from_jax(np.asarray(w["jdisc"].project[i]), np.asarray(w["jdisc"].filter[i]))
        assert torch.equal(got.project, want.project) and torch.equal(got.filter, want.filter)
        # ... and frtm_tpu reads what the port wrote
        jgot = jt.TModelCache(w["tdir"]).load(JaxSpec.from_encoded([w["enc"][i]])[0], "layer4")
        tp, tf = disc_params_to_jax(DiscParams(w["tdisc"].project[i], w["tdisc"].filter[i]))
        np.testing.assert_array_equal(np.asarray(jgot.project), tp)
        np.testing.assert_array_equal(np.asarray(jgot.filter), tf)
    f = TModelCache(w["tdir"])._fname(specs[0], "layer4")
    f.write_bytes(b"not an npz")
    with contextlib.redirect_stdout(io.StringIO()):
        assert TModelCache(w["tdir"]).load(specs[0], "layer4") is None


def test_cache_hits_and_in_batch_duplicates(weights, step_world, tmp_path):
    w = step_world
    images, labels = w["images"][0], w["labels"][0]
    cache = TModelCache(tmp_path)
    tm = port_model(weights, cache)
    enc = w["enc"][:2] + [w["enc"][0]]          # a repeat inside the batch
    specs = SampleSpec.from_encoded(enc)
    disc, hits = tm.build_disc_batch(images[[0, 1, 0]], labels[[0, 1, 0]], specs)
    assert hits == 1
    assert torch.equal(disc.filter[2], disc.filter[0])
    assert len(list(tmp_path.rglob("*.npz"))) == 2
    again, hits = tm.build_disc_batch(images[[0, 1, 0]], labels[[0, 1, 0]], specs)
    assert hits == 3 and torch.equal(again.filter, disc.filter)


def test_masked_train_step_matches_jax(weights, step_world):
    """Loss and accuracy within 1e-5, the running statistics within 1e-5 of
    their peak, the gradients and one real optimizer step.

    Gradients: within 2e-3 of their peak. The decoder's ReLUs take many
    inputs within float32 rounding of 0 at this size, and either package may
    put one on either side of the kink; tests/test_torch_train_decoder.py
    holds gradients to 1e-4 where its frames keep every ReLU input clear of
    0. Here the layer2 path reads up to 1.04e-3 of its peak (measured), every
    other parameter under 5e-5. The conv biases before a batch-statistics
    BatchNorm have an exact gradient of 0: rounding noise on both sides, held
    to 1e-4 of the same conv's weight gradient.

    The step: AMSGrad's first step moves each weight by lr * g / (|g| + eps),
    about lr * sign(g), so the updated weights are held to 1e-4 of their peak
    where |g| exceeds 1e-2 of the gradient's peak (ten times the gradient
    gap above), and elsewhere, where the two packages' gradients may have
    opposite signs, to the step's own size, 2 lr."""
    w = step_world
    tm = port_model(weights)
    disc = to_port(w["jdisc"])
    total, acc = tm.loss(disc, w["images"], w["labels"], w["mask"])
    np.testing.assert_allclose(float(total.detach()) / 2, w["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(acc), w["acc"], rtol=1e-5)
    total.backward()
    params = dict(tm.refiner.named_parameters())
    for name, p in params.items():
        want = w["grads"][name].numpy()
        if name.endswith("bblock.0.bias"):
            scale = np.abs(w["grads"][name.replace("bias", "weight")].numpy()).max()
            assert np.abs(p.grad.numpy()).max() < 1e-4 * scale, name
        else:
            close_to_peak(p.grad.numpy(), want, 2e-3, name)
    sd = tm.refiner.state_dict()
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            close_to_peak(sd[k].numpy(), w["bn"][k].numpy(), 1e-5, k)

    tm = port_model(weights)
    old = {k: v.clone() for k, v in tm.refiner.state_dict().items()}
    stats = tm.train_step(disc, w["images"], w["labels"], w["mask"], AMSGrad(
        tm.refiner.parameters(), 1e-5), 1e-3)
    np.testing.assert_allclose(stats["stats/loss"], w["loss"], rtol=1e-5)
    np.testing.assert_allclose(stats["stats/accuracy"], w["acc"], rtol=1e-5)
    for name, v in tm.refiner.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got = v.numpy()
        if name not in params:
            close_to_peak(got, w["bn"][name].numpy(), 1e-5, name)
            continue
        want = w["stepped"][name].numpy()
        g = np.abs(w["grads"][name].numpy())
        settled = g > 1e-2 * g.max()
        if name.endswith("bblock.0.bias"):
            settled[:] = False
        assert np.abs(got - want)[~settled].max(initial=0) <= 2.001e-3, name
        if settled.any():
            close_to_peak(got[settled], want[settled], 1e-4, name)
        assert not np.array_equal(got, old[name].numpy()), name


def test_batches_match_jax_under_equal_seeds(weights, tmp_path):
    dset = SyntheticTrainingDataset(n_samples=5, size=(48, 64), sample_size=2, seed=0)
    jdset = JaxSynthetic(n_samples=5, size=(48, 64), sample_size=2, seed=0)
    tr = Trainer("pb", port_model(weights), [lambda: dset], tmp_path / "c", tmp_path / "l",
                 batch_size=4, load_latest=False, rng=np.random.RandomState(11))
    jtr = jt.Trainer("pb", jax_model(weights), [lambda: jdset], tmp_path / "jc",
                     tmp_path / "jl", max_epochs=1, batch_size=4, load_latest=False)
    got = list(tr._batches(dset))
    np.random.seed(11)
    want = list(jtr._batches(jdset))
    assert len(got) == len(want) == 2
    for (im, lb, sp, m), (jim, jlb, jsp, jm) in zip(got, want):
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_array_equal(lb, jlb)
        np.testing.assert_array_equal(m, jm)
        assert [s.encoded() for s in sp] == [s.encoded() for s in jsp]
    np.testing.assert_array_equal(got[1][3], [1, 0, 0, 0])
    np.testing.assert_array_equal(got[1][0][:, 1], got[1][0][:, 0])   # cyclic repeats


def test_three_epochs_loss_falls_as_jax_does_and_resumes(weights, tmp_path):
    def dset():
        return SyntheticTrainingDataset(n_samples=8, size=(96, 128), sample_size=3, seed=0)

    def jdset():
        return JaxSynthetic(n_samples=8, size=(96, 128), sample_size=3, seed=0)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tr = Trainer("t1", port_model(weights, TModelCache(tmp_path / "cache")), [dset],
                     tmp_path / "ckpt", tmp_path / "log", max_epochs=3, batch_size=4,
                     load_latest=False, rng=np.random.RandomState(0))
        tr.train()
        jtr = jt.Trainer("t1", jax_model(weights, jt.TModelCache(tmp_path / "jcache")), [jdset],
                         tmp_path / "jckpt", tmp_path / "jlog", max_epochs=3, batch_size=4,
                         load_latest=False)
        np.random.seed(0)
        jtr.train()
    stats = [json.loads(x) for x in open(tmp_path / "log" / "t1" / "stats.jsonl")]
    jstats = [json.loads(x) for x in open(tmp_path / "jlog" / "t1" / "stats.jsonl")]
    assert [sorted(s) for s in stats] == [sorted(s) for s in jstats]
    losses = [s["stats/loss"] for s in stats]
    jlosses = [s["stats/loss"] for s in jstats]
    assert losses[-1] < 0.9 * losses[0] and jlosses[-1] < 0.9 * jlosses[0], (losses, jlosses)
    # the same data, batches and starting weights; the target models agree
    # to 1e-2 of their peak (F5), so the losses follow each other closely
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3)
    assert [s["stats/fcache_hits"] for s in stats] == [0.0, 4.0, 4.0]
    assert [s["stats/fcache_hits"] for s in jstats] == [0.0, 4.0, 4.0]
    assert all(s["stats/lr"] == 1e-3 for s in stats)
    assert "sps=" in out.getvalue()

    ckpts = sorted((tmp_path / "ckpt" / "t1").glob("t1_ep*.pth"))
    assert [c.name for c in ckpts] == ["t1_ep0001.pth", "t1_ep0002.pth", "t1_ep0003.pth"]
    with contextlib.redirect_stdout(io.StringIO()):
        tr2 = Trainer("t1", port_model(weights), [dset], tmp_path / "ckpt", tmp_path / "log",
                      max_epochs=3, batch_size=4)
    assert tr2.epoch == 3 and tr2.optimizer.count == tr.optimizer.count == 6
    for k, v in tr.model.refiner.state_dict().items():
        assert torch.equal(tr2.model.refiner.state_dict()[k], v), k
    # BN weight and bias are trained; the running statistics moved
    bn = tr.model.refiner.RRB1["layer5"].bblock[1]
    assert not torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert not torch.equal(bn.bias, torch.zeros_like(bn.bias))
    assert not torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))


def test_steplr_and_refusals(weights, tmp_path):
    tr = Trainer("t2", port_model(weights), [], tmp_path / "c", tmp_path / "l", lr=1e-3,
                 lr_step=127, lr_gamma=0.1, load_latest=False)
    for epoch, lr in ((1, 1e-3), (127, 1e-3), (128, 1e-4), (255, 1e-5)):
        tr.epoch = epoch
        assert abs(tr._lr() - lr) < 1e-15
    with pytest.raises(NotImplementedError, match="queue item 7"):
        Trainer("t3", port_model(weights), [], tmp_path / "c", tmp_path / "l", mesh=object())


def test_train_entry_point_surface(tmp_path):
    from frtm_tpu_torch import train
    for extra in (["--dp", "2"], ["--multihost"]):
        with pytest.raises(SystemExit, match="queue item 7"):
            train.main(["x", "--dev", "cpu", *extra])
    # without --dev cpu it asks for the card, which this machine lacks
    res = subprocess.run([sys.executable, "-m", "frtm_tpu_torch.train", "x", "--dset",
                          "synthetic", "--workspace", str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not (tmp_path / "checkpoints").exists()
