"""One rank of the data-parallel tests' gloo worlds on the CPU
(tests/test_torch_dp_train.py runs it as a child process; it imports torch
and the port, never JAX):

    python tests/torch_dp_worker.py step WORKDIR RANK WORLD
    python tests/torch_dp_worker.py trainer WORKDIR RANK WORLD

The ranks meet through WORKDIR/rendezvous. `step` reads WORKDIR/inputs.pt
(weights, a global batch, target models and masks) and writes
WORKDIR/step{RANK}.pt: per case the rank's gradients after the step's
all-reduce, the global stats and the running statistics; `trainer` trains
two epochs with the Trainer API on a shared workspace, resumes to a third,
and writes WORKDIR/trainer{RANK}.pt.
"""
import contextlib
import io
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from frtm_tpu_torch.config import eval_config  # noqa: E402
from frtm_tpu_torch.data.training_datasets import SyntheticTrainingDataset  # noqa: E402
from frtm_tpu_torch.models.discriminator import DiscParams  # noqa: E402
from frtm_tpu_torch.models.resnet import ResNet, resnet_out_channels  # noqa: E402
from frtm_tpu_torch.models.seg_network import SegNetwork  # noqa: E402
from frtm_tpu_torch.parallel import (batch_sharded, init_distributed, make_mesh,  # noqa: E402
                                     make_sharded_train_step, replicated)
from frtm_tpu_torch.ops.collectives import all_reduce_grads, all_reduce_sum  # noqa: E402
from frtm_tpu_torch.runtime.trainer import (AMSGrad, TModelCache, Trainer,  # noqa: E402
                                            TrainerModel)

ARCH = "resnet18"
BN_STATS = ("running_mean", "running_var")


def tiny_config():
    """tests/test_torch_trainer.py's configuration."""
    cfg = eval_config(ARCH, fast=True, num_aug=3)
    return replace(cfg, disc=replace(
        cfg.disc, c_channels=16, init_iters=(3, 5), update_iters=(3,), memory_size=8,
        filter_reg=(1e-5, 1e-4), precond=(1e-5, 1e-4), cg_forgetting_rate=75,
        pixel_weighting_method="none"))


CH = {L: c for L, c in resnet_out_channels(ARCH).items() if L in tiny_config().refnet_layers}


class GradRecorder:
    """The optimizer interface of make_sharded_train_step that records the
    gradients it is given (after their all-reduce) and moves nothing."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self, lr):
        self.grads = [p.grad.detach().clone() for p in self.params]


def build_model(weights, cache=None, disc_params0=None):
    backbone, refiner = ResNet(ARCH), SegNetwork(CH)
    backbone.load_state_dict(weights["backbone"])
    refiner.load_state_dict(weights["refiner"])
    return TrainerModel(tiny_config(), backbone, refiner, cache or TModelCache(None, False),
                        device="cpu", disc_params0=disc_params0)


def named_grads(model, grads):
    return {n: g for (n, _), g in zip(model.refiner.named_parameters(), grads)}


def running_stats(model):
    return {k: v.clone() for k, v in model.refiner.state_dict().items() if k.endswith(BN_STATS)}


def step_cases(workdir, mesh):
    """Per mask of inputs.pt: the synchronised step; the step with local
    BatchNorm statistics (gradients all-reduced); the step without the
    gradient all-reduce (BatchNorm synchronised); and one AMSGrad step."""
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    rows = {k: batch_sharded(mesh, inputs[k], 1) for k in ("images", "labels")}
    disc = DiscParams(batch_sharded(mesh, inputs["project"], 0),
                      batch_sharded(mesh, inputs["filter"], 0))
    out = {}
    for tag, mask in inputs["masks"].items():
        mask = batch_sharded(mesh, mask, 0)
        model = build_model(inputs)
        replicated(mesh, model.refiner)
        rec = GradRecorder(model.refiner.parameters())
        stats = make_sharded_train_step(model, mesh)(disc, rows["images"], rows["labels"],
                                                     mask, rec, 1.0)
        out[tag] = {"stats": stats, "grads": named_grads(model, rec.grads),
                    "bn": running_stats(model)}
        for case, bn_group, reduce_grads in (("nosync_bn", None, True),
                                             ("nosync_grad", mesh.group, False)):
            model = build_model(inputs)
            n_valid = torch.clamp_min(all_reduce_sum(torch.as_tensor(mask).sum(), mesh.group), 1)
            total, acc = model.loss(disc, rows["images"], rows["labels"], mask,
                                    bn_group=bn_group, n_valid=n_valid)
            total.backward()
            params = list(model.refiner.parameters())
            if reduce_grads:
                all_reduce_grads(params, mesh.group)
            out[tag][case] = {"grads": named_grads(model, [p.grad for p in params]),
                              "bn": running_stats(model)}
        model = build_model(inputs)
        opt = AMSGrad(model.refiner.parameters())
        make_sharded_train_step(model, mesh)(disc, rows["images"], rows["labels"], mask, opt,
                                             1e-3)
        out[tag]["stepped"] = {k: v.clone() for k, v in model.refiner.state_dict().items()}
    return out


def trainer_run(workdir, mesh):
    """Two epochs on a shared workspace, then a new Trainer resumed to three;
    rank 0 alone may write."""
    weights = torch.load(workdir / "weights.pt", weights_only=False)
    saves = []
    save = Trainer.save_checkpoint

    def counted(self):
        saves.append(self.epoch)
        save(self)

    Trainer.save_checkpoint = counted

    def dset():
        return SyntheticTrainingDataset(n_samples=8, size=(64, 96), sample_size=3, seed=0)

    def trainer(epochs, load_latest):
        model = build_model(weights, TModelCache(workdir / "cache"),
                            disc_params0=weights["disc_params0"])
        return Trainer("dp", model, [dset], workdir / "ckpt", workdir / "log",
                       max_epochs=epochs, batch_size=4, load_latest=load_latest, mesh=mesh)

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        first = trainer(2, False)
        first.train()
        resumed = trainer(3, True)
        loaded_epoch = resumed.epoch
        resumed.train()
    return {"saves": saves, "loaded_epoch": loaded_epoch, "final_epoch": resumed.epoch,
            "refiner": {k: v.clone() for k, v in resumed.model.refiner.state_dict().items()},
            "text": text.getvalue()}


def main(mode, workdir, rank, world):
    torch.set_num_threads(2)
    workdir = Path(workdir)
    init_distributed(f"file://{workdir / 'rendezvous'}", int(world), int(rank), timeout_s=300)
    mesh = make_mesh(int(world), device="cpu")
    out = step_cases(workdir, mesh) if mode == "step" else trainer_run(workdir, mesh)
    torch.save(out, workdir / f"{mode}{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:5])
