"""The port's Trainer over several processes and the `train` entry point's
--dp / --multihost on the CPU (gloo worlds of child processes; see
tests/test_torch_dp_train.py for the step itself): two processes of the
Trainer API, their losses against one process's, resumption and rank 0's
writes; `--dp 2` end to end and the refusals; and the target-model cache's
atomic write, which ranks solving the same target model rely on.
"""
import contextlib
import io
import json
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from frtm_tpu.models import init_resnet, init_seg_network
from frtm_tpu.models.discriminator import init_disc_params
from frtm_tpu_torch import train
from frtm_tpu_torch.data.training_datasets import SampleSpec, SyntheticTrainingDataset
from frtm_tpu_torch.models.discriminator import DiscParams
from frtm_tpu_torch.parallel import init_distributed
from frtm_tpu_torch.runtime.trainer import TModelCache, Trainer
from frtm_tpu_torch.utils.convert import (disc_params_from_jax, resnet_from_jax,
                                          seg_network_from_jax)
from torch_dp_worker import CH, build_model
from test_torch_dp_train import JCFG, ROOT, child_env, no_torchrun, run_ranks  # noqa: F401

torch.set_num_threads(2)


class EpochSeeded:
    """An rng for a one-process Trainer that draws epoch e's order from
    RandomState(e), as a run of several processes does."""

    def __init__(self):
        self.epoch = 0

    def permutation(self, n):
        self.epoch += 1
        return np.random.RandomState(self.epoch).permutation(n)


def test_trainer_in_two_processes(tmp_path):
    """Two gloo processes run the Trainer API for two epochs on a shared
    workspace, then a new Trainer in each resumes to a third: the loss
    falls; only rank 0 saves checkpoints and writes stats.jsonl; both ranks
    load epoch 2 and end equal bit for bit; the losses are within rtol 2e-3
    of one process's on the same epoch-seeded batches (each rank solves its
    own rows' target models; tests/test_torch_trainer.py's bound against
    frtm_tpu)."""
    bb = init_resnet(jax.random.PRNGKey(1), "resnet18")
    ref = init_seg_network(jax.random.PRNGKey(2), CH, use_bn=True)
    d0 = init_disc_params(jax.random.PRNGKey(0), JCFG.disc)
    weights = {"backbone": resnet_from_jax(jax.tree.map(np.asarray, bb)),
               "refiner": seg_network_from_jax(jax.tree.map(np.asarray, ref)),
               "disc_params0": disc_params_from_jax(np.asarray(d0.project),
                                                    np.asarray(d0.filter))}
    torch.save(weights, tmp_path / "weights.pt")
    ranks = run_ranks("trainer", tmp_path)

    stats = [json.loads(x) for x in open(tmp_path / "log" / "dp" / "stats.jsonl")]
    assert [s["epoch"] for s in stats] == [1, 2, 3]
    losses = [s["stats/loss"] for s in stats]
    assert losses[2] < losses[1] < losses[0], losses
    assert [r["saves"] for r in ranks] == [[1, 2, 3], []]
    assert sorted(p.name for p in (tmp_path / "ckpt" / "dp").iterdir()) == \
        ["dp_ep0001.pth", "dp_ep0002.pth", "dp_ep0003.pth"]
    assert [(r["loaded_epoch"], r["final_epoch"]) for r in ranks] == [(2, 3), (2, 3)]
    assert all("Starting epoch 3" in r["text"] for r in ranks)
    assert all(torch.equal(v, ranks[1]["refiner"][k]) for k, v in ranks[0]["refiner"].items())

    def dset():
        return SyntheticTrainingDataset(n_samples=8, size=(64, 96), sample_size=3, seed=0)

    model = build_model(weights, TModelCache(tmp_path / "one_cache"),
                        disc_params0=weights["disc_params0"])
    with contextlib.redirect_stdout(io.StringIO()):
        Trainer("one", model, [dset], tmp_path / "one_ckpt", tmp_path / "one_log",
                max_epochs=3, batch_size=4, load_latest=False, rng=EpochSeeded()).train()
    one = [json.loads(x)["stats/loss"] for x in open(tmp_path / "one_log" / "one" / "stats.jsonl")]
    np.testing.assert_allclose(losses, one, rtol=2e-3)


def test_train_entry_point_dp_on_the_cpu(no_torchrun, tmp_path):
    """`python -m frtm_tpu_torch.train --dp 2 --dev cpu` spawns two gloo
    processes that train one epoch of the synthetic set (32 samples, two
    steps of a global batch of 16) and write one checkpoint and one
    statistics line (about 35 s, two threads a rank)."""
    res = subprocess.run([sys.executable, "-m", "frtm_tpu_torch.train", "dp", "--dp", "2",
                          "--dev", "cpu", "--dset", "synthetic", "--ftext", "resnet18",
                          "--max-epochs", "1", "--workspace", str(tmp_path)],
                         cwd=ROOT, env=child_env(), capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    assert "multihost: process 0/2 on cpu" in res.stdout
    assert "multihost: process 1/2 on cpu" in res.stdout
    stats = [json.loads(x) for x in open(tmp_path / "logs" / "dp" / "stats.jsonl")]
    assert len(stats) == 1 and np.isfinite(stats[0]["stats/loss"])
    assert [p.name for p in (tmp_path / "checkpoints" / "dp").iterdir()] == ["dp_ep0001.pth"]


def test_train_entry_point_refusals(no_torchrun, monkeypatch, tmp_path):
    """The reference's divisibility errors, and --dp against a world of
    another size (init_distributed stands in for torchrun's world)."""
    base = ["x", "--dev", "cpu", "--dset", "synthetic", "--workspace", str(tmp_path)]
    cases = [(["--dp", "3", "--batch-size", "16"], "divisible by --dp 3"),
             (["--dp", "-1"], "the number of processes")]
    for extra, message in cases:
        err = io.StringIO()
        with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(err):
            train.main(base + extra)
        assert e.value.code == 2 and message in err.getvalue(), err.getvalue()
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setattr("frtm_tpu_torch.parallel.distributed.init_distributed",
                        lambda backend, device: (0, 3))
    for extra, message in ((["--dp", "2", "--batch-size", "4"], "in a world of 3 processes"),
                           (["--multihost", "--batch-size", "16"],
                            "divisible by the 3 processes")):
        err = io.StringIO()
        with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(err):
            train.main(base + extra)
        assert e.value.code == 2 and message in err.getvalue(), err.getvalue()
    assert not (tmp_path / "checkpoints").exists()


def test_a_cpu_run_never_takes_a_card(no_torchrun, monkeypatch, tmp_path):
    """On a machine with a card, `train --dp 2 --dev cpu` joins each rank on
    the CPU and init_distributed then leaves the card alone (rank 1 of two
    would otherwise ask a one-card machine for cuda:1); a run on the card
    makes cuda:LOCAL_RANK current. The spawned ranks run inline here and
    stop at the rendezvous."""
    set_devices, joined = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", set_devices.append)
    monkeypatch.setenv("LOCAL_RANK", "0")

    class Joined(Exception):
        pass

    def join(coordinator, n, rank, backend, device):
        joined.append((rank, n, backend, device))
        raise Joined

    def inline(fn, args, nprocs, join, start_method):
        for rank in range(nprocs):
            with pytest.raises(Joined):
                fn(rank, *args)

    with monkeypatch.context() as m:
        m.setattr("frtm_tpu_torch.parallel.distributed.init_distributed", join)
        m.setattr("torch.multiprocessing.start_processes", inline)
        assert train.main(["x", "--dp", "2", "--dev", "cpu", "--dset", "synthetic",
                           "--workspace", str(tmp_path)]) is None
    assert joined == [(0, 2, "gloo", "cpu"), (1, 2, "gloo", "cpu")]

    init_distributed(f"file://{tmp_path / 'cpu'}", 1, 0, timeout_s=60, device="cpu")
    dist.destroy_process_group()
    assert set_devices == []
    monkeypatch.setenv("LOCAL_RANK", "1")
    init_distributed(f"file://{tmp_path / 'card'}", 1, 0, timeout_s=60, device="cuda")
    dist.destroy_process_group()
    assert set_devices == [1]


def test_cache_save_is_atomic(tmp_path, monkeypatch):
    """TModelCache.save writes under a temporary name and renames: a reader
    racing a writer of the same target model always reads a whole file, and
    a write that fails leaves the previous file and no temporary one."""
    cache = TModelCache(tmp_path)
    spec = SampleSpec("seq", 1, frames=[0, 1, 2], frame0_id=0)
    rng = np.random.RandomState(0)
    params = [DiscParams(torch.from_numpy(rng.randn(16, 512, 1, 1).astype(np.float32)),
                         torch.from_numpy(rng.randn(1, 16, 3, 3).astype(np.float32)))
              for _ in range(2)]
    cache.save(spec, "layer4", params[0])
    stop, torn = threading.Event(), []

    def writer():
        for i in range(200):
            cache.save(spec, "layer4", params[i % 2])
        stop.set()

    def reader():
        with contextlib.redirect_stdout(io.StringIO()):
            while not stop.is_set():
                got = cache.load(spec, "layer4")
                if got is None or not any(torch.equal(got.filter, p.filter) for p in params):
                    torn.append(got)

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not torn, len(torn)

    def failing(fh, **arrays):
        fh.write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", failing)
    with pytest.raises(OSError, match="disk full"):
        cache.save(spec, "layer4", params[1])
    assert [p.name for p in (tmp_path / "seq").iterdir()] == ["00000.1.layer4.npz"]
    assert torch.equal(cache.load(spec, "layer4").filter, params[1].filter)
