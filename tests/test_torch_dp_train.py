"""The port's data-parallel training (parallel/train_step.py, the
synchronised BatchNorm of ops/conv.py, Trainer(mesh=), train --dp /
--multihost) on the CPU, in gloo worlds of child processes
(tests/torch_dp_worker.py; rendezvous through a file under the test's
temporary directory).

* Two ranks, each on its half of a global batch of 4 (rn18, 64x96, three
  frames, a visible object, a partial mask), against frtm_tpu's
  make_sharded_train_step on a 2-device CPU mesh with optax.sgd(1.0), whose
  update is the gradient: loss and accuracy rtol 1e-5, gradients 2e-3 of
  their peak, running statistics 1e-5 of their peak (the bounds of
  tests/test_torch_trainer.py::test_masked_train_step_matches_jax, whose
  docstring gives their measured reasons). The same ranks with local
  BatchNorm statistics, or without the gradient all-reduce, miss those
  bounds at least tenfold: the comparison sees a missing synchronisation.
* The two ranks against one process of the port, also where rank 1's rows
  are all padding; the ranks' refiners bit-equal after an AMSGrad step.
* A world of one against the meshless step: bit-equal.
* Two simulated ranks' batches against frtm_tpu's; the refusal of several
  processes without a mesh.
* Two processes of `train --multihost --dev cpu` in one gloo world.
The Trainer API and `train --dp` over several processes are in
tests/test_torch_dp_trainer.py.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from frtm_tpu.config import eval_config as jax_eval_config
from frtm_tpu.data.training_datasets import SyntheticTrainingDataset as JaxSynthetic
from frtm_tpu.models import init_resnet, init_seg_network
from frtm_tpu.models.discriminator import init_disc_params
from frtm_tpu.parallel import make_mesh as jax_make_mesh
from frtm_tpu.parallel import make_sharded_train_step as jax_sharded_step
from frtm_tpu.runtime import trainer as jt
from frtm_tpu_torch.data.training_datasets import SyntheticTrainingDataset
from frtm_tpu_torch.models.discriminator import DiscParams
from frtm_tpu_torch.models.resnet import ResNet
from frtm_tpu_torch.models.seg_network import SegNetwork
from frtm_tpu_torch.parallel import Mesh, init_distributed, make_mesh, make_sharded_train_step
from frtm_tpu_torch.runtime import trainer as port_trainer
from frtm_tpu_torch.runtime.trainer import AMSGrad, Trainer
from frtm_tpu_torch.utils.convert import (disc_params_from_jax, resnet_from_jax,
                                          seg_network_from_jax)
from torch_dp_worker import CH, GradRecorder, build_model, named_grads, running_stats
from test_torch_trainer import _tiny

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_dp_worker.py")
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
JCFG = _tiny(jax_eval_config("resnet18", fast=True, num_aug=3))
B, T, H, W = 4, 3, 64, 96
LOSS_RTOL, GRAD_OF_PEAK, BN_OF_PEAK = 1e-5, 2e-3, 1e-5
MASKS = {"partial": [1, 1, 1, 0], "padded_rank": [1, 1, 0, 0]}


def child_env():
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"    # two threads a rank, as in this process
    return env


def run_ranks(mode, workdir, n=2, timeout=400):
    """`n` ranks of tests/torch_dp_worker.py; returns what each wrote."""
    children = [subprocess.Popen([sys.executable, str(WORKER), mode, str(workdir), str(r),
                                  str(n)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True, env=child_env(), cwd=workdir)
                for r in range(n)]
    try:
        outs = [child.communicate(timeout=timeout)[0] for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    for rank, (child, out) in enumerate(zip(children, outs)):
        assert child.returncode == 0, (rank, out[-3000:])
    return [torch.load(workdir / f"{mode}{r}.pt", weights_only=False) for r in range(n)]


def gap_of_peak(got, want, scale=None):
    """max |got - want| over the peak of |scale| (by default |want|)."""
    scale = want if scale is None else scale
    return float((got - want).abs().max() / scale.abs().max())


def grad_gaps(got, want, scale=None):
    """Per parameter, the gradient's gap as a share of its peak (the peak of
    `scale`, by default `want`); a conv bias before a batch-statistics
    BatchNorm has an exact gradient of 0 (rounding noise on both sides), so
    its gap is taken against the same conv's weight gradient
    (tests/test_torch_trainer.py)."""
    scale = want if scale is None else scale
    gaps = {}
    for name, g in got.items():
        peak_of = scale[name.replace("bias", "weight") if name.endswith("bblock.0.bias")
                        else name]
        gaps[name] = gap_of_peak(g, want[name], peak_of)
    return gaps


def bn_gaps(got, want, scale=None):
    scale = want if scale is None else scale
    return {k: gap_of_peak(got[k], want[k], scale[k]) for k in want}


def inputs(seed=0):
    """A global batch whose object is visible (the gradients are then not
    noise covariances that cancel; tests/test_sequence_tracker.py:288-292)
    and moves from sample to sample."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((T, B, H, W, 1), np.float32)
    for b in range(B):
        labels[:, b, 12 + 4 * b:36 + 4 * b, 20 + 6 * b:52 + 6 * b] = 1.0
    images = (rng.rand(T, B, H, W, 3) * 60 + labels * 180).astype(np.float32)
    return images, labels


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX sharded step, the two ranks' cases and the one-process
    port's step, each per mask."""
    workdir = tmp_path_factory.mktemp("dp_step")
    bb = init_resnet(jax.random.PRNGKey(1), "resnet18")
    ref = init_seg_network(jax.random.PRNGKey(2), CH, use_bn=True)
    d0 = init_disc_params(jax.random.PRNGKey(0), JCFG.disc)
    jdisc = jax.tree.map(lambda x: jnp.stack([x] * B), d0)
    images, labels = inputs()

    jm = jt.TrainerModel(JCFG, bb, ref, jt.TModelCache(None, enable=False))
    tx = optax.sgd(1.0)
    old = seg_network_from_jax(jax.tree.map(np.asarray, ref))
    steps = {"single": jax.jit(lambda r, o, b, d, i, l, m: jm._train_step(r, o, b, d, i, l, m,
                                                                            tx)),
             "sharded": jax_sharded_step(jm._train_step, jax_make_mesh(2), tx)}
    jax_ref = {}
    for name, step in steps.items():
        new, _, stats = step(ref, tx.init(ref), bb, jdisc, jnp.asarray(images),
                             jnp.asarray(labels), jnp.asarray(MASKS["partial"], jnp.float32))
        new = seg_network_from_jax(jax.tree.map(np.asarray, new))
        jax_ref[name] = {
            "loss": float(stats["stats/loss"]), "acc": float(stats["stats/accuracy"]),
            "grads": {k: old[k] - new[k] for k in old
                      if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))},
            "bn": {k: new[k] for k in new if k.endswith(("running_mean", "running_var"))}}

    d = disc_params_from_jax(np.asarray(d0.project), np.asarray(d0.filter))
    weights = {"backbone": resnet_from_jax(jax.tree.map(np.asarray, bb)),
               "refiner": old}
    torch.save({**weights, "images": images, "labels": labels,
                "project": torch.stack([d.project] * B), "filter": torch.stack([d.filter] * B),
                "masks": {k: torch.tensor(m, dtype=torch.float32) for k, m in MASKS.items()}},
               workdir / "inputs.pt")
    ranks = run_ranks("step", workdir)

    one = {}
    disc = DiscParams(torch.stack([d.project] * B), torch.stack([d.filter] * B))
    lone = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))
    for tag, mask in MASKS.items():
        model = build_model(weights)
        rec = GradRecorder(model.refiner.parameters())
        st = make_sharded_train_step(model, lone)(disc, images, labels,
                                                  np.asarray(mask, np.float32), rec, 1.0)
        one[tag] = {"stats": st, "grads": named_grads(model, rec.grads),
                    "bn": running_stats(model)}
    return {"jax": jax_ref, "ranks": ranks, "one": one}


def readings(got, want, scale):
    """The gaps of `got` to `want` as shares of `scale`'s values: loss,
    accuracy, the worst gradient (of its peak) and the worst running
    statistic (of its peak)."""
    grads = grad_gaps(got["grads"], want["grads"], scale["grads"])
    bn = bn_gaps(got["bn"], want["bn"], scale["bn"])
    return (abs(got["stats"]["stats/loss"] - want["loss"]) / abs(scale["loss"]),
            abs(got["stats"]["stats/accuracy"] - want["acc"]) / abs(scale["acc"]),
            max(grads.values()), max(bn.values()))


def test_two_ranks_match_frtm_tpu(world):
    """Each rank's loss, accuracy, all-reduced gradients and running
    statistics against frtm_tpu's train step on the whole global batch
    (one program, the computation its sharded step is defined to equal):
    the bounds of test_masked_train_step_matches_jax.

    And against frtm_tpu's make_sharded_train_step on a 2-device CPU mesh.
    That step lies farther from frtm_tpu's own one-program step than those
    bounds (measured: loss 1.45e-4 relative, accuracy 1.5 %, gradients 0.63
    of a parameter's peak and 4.5 % in relative L2 over all of them, running
    statistics 7.4e-4 of their peak; its own test holds it within 0.05 in
    relative L2). So each rank is held within the sharded step's own gap to
    the one-program step plus the bounds: no farther from JAX's sharded step
    than JAX's one-program step is (each gap a share of the one-program
    step's values)."""
    single, sharded = world["jax"]["single"], world["jax"]["sharded"]
    bounds = (LOSS_RTOL, LOSS_RTOL, GRAD_OF_PEAK, BN_OF_PEAK)
    jax_gap = readings({"stats": {"stats/loss": sharded["loss"], "stats/accuracy": sharded["acc"]},
                        "grads": sharded["grads"], "bn": sharded["bn"]}, single, single)
    for rank, got in enumerate(world["ranks"]):
        got = got["partial"]
        one = readings(got, single, single)
        assert all(r <= b for r, b in zip(one, bounds)), (rank, one)
        two = readings(got, sharded, single)
        assert all(r <= g + b for r, g, b in zip(two, jax_gap, bounds)), (rank, two, jax_gap)


@pytest.mark.parametrize("case", ["nosync_bn", "nosync_grad"])
def test_a_missing_synchronisation_misses_the_bounds_tenfold(world, case):
    """Local BatchNorm statistics (gradients all-reduced), or gradients not
    all-reduced (BatchNorm synchronised): each rank's gradients lie at least
    ten times the gradient bound from frtm_tpu's, and with local statistics
    the running statistics at least ten times theirs."""
    want = world["jax"]["single"]
    for got in world["ranks"]:
        got = got["partial"][case]
        assert max(grad_gaps(got["grads"], want["grads"]).values()) >= 10 * GRAD_OF_PEAK
        if case == "nosync_bn":
            assert max(bn_gaps(got["bn"], want["bn"]).values()) >= 10 * BN_OF_PEAK


@pytest.mark.parametrize("tag", list(MASKS))
def test_two_ranks_match_one_process(world, tag):
    """Against the port's step on the whole batch in one process, within the
    same bounds; with mask [1, 1, 0, 0] rank 1's rows are all padding and
    add 0. After an AMSGrad step the ranks' refiners are equal bit for bit."""
    want = world["one"][tag]
    ranks = [r[tag] for r in world["ranks"]]
    for rank, got in enumerate(ranks):
        for key in ("stats/loss", "stats/accuracy"):
            assert np.isfinite(got["stats"][key]), (rank, got["stats"])
            np.testing.assert_allclose(got["stats"][key], want["stats"][key], rtol=LOSS_RTOL)
        gaps = grad_gaps(got["grads"], want["grads"])
        assert max(gaps.values()) <= GRAD_OF_PEAK, (rank, max(gaps, key=gaps.get))
        assert max(bn_gaps(got["bn"], want["bn"]).values()) <= BN_OF_PEAK, rank
    a, b = (r["stepped"] for r in ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture
def no_torchrun(monkeypatch):
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)


def test_world_of_one_is_bit_equal_to_the_meshless_step(no_torchrun, tmp_path):
    """A gloo world of one rank: make_sharded_train_step over its mesh gives
    TrainerModel.train_step's losses, accuracies and refiner, bit for bit,
    over two AMSGrad steps (the partial mask, then all valid)."""
    images, labels = inputs(1)
    bb = init_resnet(jax.random.PRNGKey(3), "resnet18")
    ref = init_seg_network(jax.random.PRNGKey(4), CH, use_bn=True)
    d0 = init_disc_params(jax.random.PRNGKey(5), JCFG.disc)
    weights = {"backbone": resnet_from_jax(jax.tree.map(np.asarray, bb)),
               "refiner": seg_network_from_jax(jax.tree.map(np.asarray, ref))}
    d = disc_params_from_jax(np.asarray(d0.project), np.asarray(d0.filter))
    disc = DiscParams(torch.stack([d.project] * B), torch.stack([d.filter] * B))
    masks = [np.asarray(MASKS["partial"], np.float32), np.ones(B, np.float32)]

    meshless = build_model(weights)
    opt = AMSGrad(meshless.refiner.parameters())
    want = [meshless.train_step(disc, images, labels, m, opt, 1e-3) for m in masks]

    init_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, timeout_s=60)
    try:
        mesh = make_mesh(1, device="cpu")
        assert mesh.group is not None and mesh.size == 1
        model = build_model(weights)
        opt = AMSGrad(model.refiner.parameters())
        step = make_sharded_train_step(model, mesh)
        got = [step(disc, images, labels, m, opt, 1e-3) for m in masks]
    finally:
        dist.destroy_process_group()
    assert got == want
    sd = meshless.refiner.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in model.refiner.state_dict().items())


def random_weights():
    return {"backbone": ResNet("resnet18").state_dict(), "refiner": SegNetwork(CH).state_dict()}


def test_two_ranks_batches_concatenate_to_frtm_tpu_multiprocess_batches(tmp_path):
    """Two simulated processes of one epoch draw frtm_tpu's epoch-seeded
    global order and materialise its rows: each rank's batches equal the
    JAX trainer's for that rank, and together they are the global batch."""
    dset = SyntheticTrainingDataset(n_samples=6, size=(48, 64), sample_size=2, seed=0)
    jdset = JaxSynthetic(n_samples=6, size=(48, 64), sample_size=2, seed=0)
    model = build_model(random_weights())
    got, want = [], []
    for pid in range(2):
        mesh = Mesh(group=None, rank=pid, size=2, device=torch.device("cpu"))
        tr = Trainer("mh", model, [lambda: dset], tmp_path / "c", tmp_path / "l",
                     batch_size=4, load_latest=False, mesh=mesh)
        tr.epoch = 1
        got.append(list(tr._batches(dset)))
        want.append(jax_rank_batches(jdset, pid))
    for pid in range(2):
        assert len(got[pid]) == len(want[pid]) == 2
        for (im, lb, sp, m), (jim, jlb, jsp, jm_) in zip(got[pid], want[pid]):
            assert im.shape[1] == 2
            np.testing.assert_array_equal(im, jim)
            np.testing.assert_array_equal(lb, jlb)
            np.testing.assert_array_equal(m, jm_)
            assert [s.encoded() for s in sp] == [s.encoded() for s in jsp]
    order = np.random.RandomState(1).permutation(len(dset))
    glob = np.concatenate([got[0][0][0], got[1][0][0]], axis=1)
    np.testing.assert_array_equal(glob, np.stack([np.stack([dset[int(i)][0][t]
                                                            for i in order[:4]])
                                                  for t in range(2)]))
    # the last batch: 2 real samples, cyclic repeats; rank 1 holds padding only
    np.testing.assert_array_equal(got[0][1][3], [1, 1])
    np.testing.assert_array_equal(got[1][1][3], [0, 0])


def jax_rank_batches(jdset, pid):
    """frtm_tpu's Trainer._batches of process `pid` of two, epoch 1 (the
    loop's state only: no model is needed to draw batches)."""
    jtr = jt.Trainer.__new__(jt.Trainer)
    jtr.batch_size, jtr.epoch, jtr._n_proc, jtr._pid = 4, 1, 2, pid
    return list(jtr._batches(jdset))


def test_several_processes_without_a_mesh_are_refused(monkeypatch, tmp_path):
    monkeypatch.setattr(port_trainer, "process_count", lambda: 2)
    model = build_model(random_weights())
    with pytest.raises(ValueError, match="requires a global mesh"):
        Trainer("x", model, [], tmp_path / "c", tmp_path / "l", load_latest=False)



def test_train_entry_point_multihost_in_two_processes(no_torchrun, tmp_path):
    """Two processes of `python -m frtm_tpu_torch.train --multihost --dev
    cpu`, each given torchrun's variables by hand (a free port on localhost),
    join one gloo world and train one epoch of the synthetic set; rank 0
    alone writes the checkpoint and the statistics line (about 35 s)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(child_env(), MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2")
    argv = [sys.executable, "-m", "frtm_tpu_torch.train", "mh", "--multihost", "--dev", "cpu",
            "--dset", "synthetic", "--ftext", "resnet18", "--max-epochs", "1", "--workspace",
            str(tmp_path)]
    children = [subprocess.Popen(argv, cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(2)]
    try:
        outs = [child.communicate(timeout=600)[0] for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    for rank, (child, out) in enumerate(zip(children, outs)):
        assert child.returncode == 0, (rank, out[-3000:])
        assert f"multihost: process {rank}/2 on cpu" in out
    stats = (tmp_path / "logs" / "mh" / "stats.jsonl").read_text().splitlines()
    assert len(stats) == 1
    assert [p.name for p in (tmp_path / "checkpoints" / "mh").iterdir()] == ["mh_ep0001.pth"]
