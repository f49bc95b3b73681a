"""The port's train step against the benchmark's plain reference
(benchmark/reference/trainer.py: plain float32 torch, no kernel of the port),
the reference's AMSGrad against torch.optim.Adam(amsgrad=True), and the
Trainer's `stop` and its spans and counters (runtime/trainer.py).

The step: rn101 at 64x112, batch 2, 3 frames a sample, on seeded random
weights (the benchmark's own, harness/weights.py), two steps, so that the
bias corrections at t = 2 are checked too. The Trainer: rn18 at 48x64 on
synthetic samples, batch 2."""
import threading

import numpy as np
import pytest
import torch

from benchmark.harness import weights as wt
from benchmark.harness.train import ZERO_GRAD_SUFFIX, make_sample
from benchmark.reference import trainer as ref
from benchmark.reference.resnet import RESNET_SPECS
from benchmark.reference.resnet import ResNet as RefResNet
from frtm_tpu_torch.config import eval_config
from frtm_tpu_torch.data.training_datasets import SyntheticTrainingDataset
from frtm_tpu_torch.models.discriminator import DiscParams
from frtm_tpu_torch.models.resnet import ResNet, resnet_out_channels
from frtm_tpu_torch.models.seg_network import SegNetwork
from frtm_tpu_torch.runtime.trainer import AMSGrad, TModelCache, Trainer, TrainerModel
from frtm_tpu_torch.train import train_config
from frtm_tpu_torch.utils import profiling
from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network

ARCH = "resnet101"
SIZE = (64, 112)
B, T = 2, 3
LAYERS = ("layer5", "layer4", "layer3", "layer2")
SEED = 20200614


def rel(a, b):
    return float((a - b).norm() / b.norm())


class Capturing(AMSGrad):
    """AMSGrad that keeps each step's gradients as it is given them."""

    def step(self, lr):
        self.grads = [p.grad.clone() for p in self.params]
        super().step(lr)


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(2)
    cfg = train_config(ARCH)
    ch = {L: c for L, c in resnet_out_channels(ARCH).items() if L in LAYERS}
    bsd = wt.backbone_state(ARCH, SEED, "cpu", lambda a: RESNET_SPECS[a][0])
    rsd = wt.refiner_state(ch, 64, SEED, "cpu")
    backbone = ResNet(ARCH)
    backbone.load_state_dict(bsd)
    refiner = SegNetwork(ch, 1, 64)
    refiner.load_state_dict(rsd)
    model = TrainerModel(cfg, backbone, refiner, TModelCache(None, enable=False), device="cpu")
    rb = RefResNet(ARCH)
    rb.load_state_dict(bsd)
    g = torch.Generator().manual_seed(3)
    cin = resnet_out_channels(ARCH)["layer4"]
    disc = DiscParams((torch.rand(B, 32, cin, 1, 1, generator=g) - 0.5) * 0.1,
                      (torch.rand(B, 1, 32, 3, 3, generator=g) - 0.5) * 0.2)
    batches = []
    for k in range(2):
        made = [make_sample({"frames": T, "objects": [[24 + 4 * i, 40]]}, SIZE, 11 + k, i)
                for i in range(B)]
        batches.append((np.stack([np.stack([m[0][t] for m in made]) for t in range(T)]),
                        np.stack([np.stack([m[1][t] for m in made]) for t in range(T)]),
                        np.ones(B, np.float32)))
    return model, rb, disc, batches


def test_train_step_matches_the_plain_reference(world):
    """Two steps of the port's TrainerModel.train_step (the plain kernels on
    the CPU, the port's folded BatchNorm, its grouped convolutions of the
    target models) against the reference's, each from the port's state
    before it.

    Loss within 1e-5 relative and running statistics within 1e-5 of their
    change's norm: float32 sums in two orders (they read 5e-8 and 2e-7).
    Gradients and the optimizer's moments within 1e-4 of their norm, each
    tensor: the ReLUs' kinks carry the rounding further (they read 2e-6 and
    3e-6). Each step's parameter change within 1e-3 of its norm: at t = 1
    AMSGrad moves every entry by about lr sign(g), so an entry whose
    gradient is rounding-sized weighs as much as the largest, and its
    relative rounding shows whole (step 1 reads up to 3.4e-4, step 2
    1.8e-5). The convolution biases before a batch-statistics BatchNorm
    (exact gradient 0) are held to 1e-4 of the same convolution's weight
    gradient instead (they read 6e-6): both sides give rounding noise
    there."""
    model, rb, disc, batches = world
    opt = Capturing(model.refiner.parameters(), 1e-5)
    names = [n for n, _ in model.refiner.named_parameters()]
    for step, (images, labels, mask) in enumerate(batches, 1):
        before = {k: v.clone() for k, v in model.refiner.state_dict().items()}
        state = {"count": opt.count, **{key: {n: t.clone() for n, t in
                                              zip(names, getattr(opt, key))}
                                        for key in ("mu", "nu", "nu_max")}}
        stats = model.train_step(disc, images, labels, mask, opt, 1e-3)
        want = ref.train_step(rb, before, disc.project, disc.filter, images, labels, mask, state,
                              1e-3, 1e-5, LAYERS, "layer4", torch.device("cpu"))
        assert opt.count == want["opt_state"]["count"] == step
        np.testing.assert_allclose(stats["stats/loss"], want["loss"], rtol=1e-5)
        after = model.refiner.state_dict()
        for n, g in zip(names, opt.grads):
            if n.endswith(ZERO_GRAD_SUFFIX):
                w = want["grads"][n[:-len("bias")] + "weight"]
                assert float(g.abs().max()) < 1e-4 * float(w.abs().max()), n
                continue
            assert rel(g, want["grads"][n]) < 1e-4, (step, n)
            assert rel(after[n] - before[n], want["params"][n] - before[n]) < 1e-3, (step, n)
        for k, v in want["running"].items():
            assert rel(after[k] - before[k], v - before[k]) < 1e-5, (step, k)
        for key in ("mu", "nu", "nu_max"):
            for n, t in zip(names, getattr(opt, key)):
                if not n.endswith(ZERO_GRAD_SUFFIX):
                    assert rel(t, want["opt_state"][key][n]) < 1e-4, (step, key, n)


def test_the_control_is_tf32_rounding():
    # 10 mantissa bits kept; a half of the last one rounds away from zero
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0 - 2 ** -9, -(1.0 + 2 ** -11)])
    assert ref.tf32_round(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, -3.0 - 2 ** -9,
                                          -(1.0 + 2 ** -10)]
    r = torch.randn(1000) * 1e3
    assert float(((ref.tf32_round(r) - r).abs() / r.abs()).max()) <= 2 ** -11
    # the rounding keeps the identity's gradient
    y = torch.ones(3, requires_grad=True)
    ref.tf32_round(y * 1.1).sum().backward()
    assert torch.allclose(y.grad, torch.full((3,), 1.1))


def test_reference_amsgrad_parts_from_torch_adam_amsgrad():
    """optax's order keeps the maximum of the bias-corrected second moments;
    torch.optim.Adam(amsgrad=True) the maximum of the raw ones, corrected
    after. They agree on the first step and part where an early gradient is
    larger than a later one."""
    p0 = torch.tensor([0.5, -0.2, 0.1])
    grads = [torch.tensor([1.0, 0.5, -2.0]), torch.tensor([0.1, 0.5, -0.2])]
    params = {"p": p0.clone()}
    state = {"count": 0, "mu": {"p": torch.zeros(3)}, "nu": {"p": torch.zeros(3)},
             "nu_max": {"p": torch.zeros(3)}}
    p = torch.nn.Parameter(p0.clone())
    adam = torch.optim.Adam([p], lr=1e-3, amsgrad=True, weight_decay=1e-5)
    steps = []
    for g in grads:
        params, state = ref.amsgrad_step(params, {"p": g}, state, 1e-3, 1e-5)
        p.grad = g.clone()
        adam.step()
        steps.append((params["p"].clone(), p.detach().clone()))
    np.testing.assert_allclose(steps[0][0], steps[0][1], rtol=1e-6)
    # the first and third entries' gradients shrink: the two orders part there
    gap = (steps[1][0] - steps[1][1]).abs()
    assert gap[0] > 1e-5 and gap[2] > 1e-5 and gap[1] < 1e-7
    # and the reference is the port's AMSGrad
    q = torch.nn.Parameter(p0.clone())
    port = AMSGrad([q], 1e-5)
    for g in grads:
        q.grad = g.clone()
        port.step(1e-3)
    np.testing.assert_allclose(q.detach(), steps[1][0], rtol=0, atol=1e-8)


def _tiny_trainer(tmp_path, n_samples=8):
    from dataclasses import replace
    cfg = eval_config("resnet18", fast=True, num_aug=3)
    cfg = replace(cfg, disc=replace(cfg.disc, c_channels=16, init_iters=(3, 5),
                                    update_iters=(3,), memory_size=8,
                                    pixel_weighting_method="none"))
    ch = {L: c for L, c in resnet_out_channels("resnet18").items() if L in cfg.refnet_layers}
    backbone = init_resnet("resnet18", torch.Generator().manual_seed(0), device="cpu")
    refiner = init_seg_network(ch, torch.Generator().manual_seed(1), device="cpu")
    model = TrainerModel(cfg, backbone, refiner, TModelCache(tmp_path / "cache"), device="cpu")
    dset = SyntheticTrainingDataset(n_samples=n_samples, size=(48, 64), sample_size=3)
    return Trainer("s", model, [lambda: dset], tmp_path / "ckpt", tmp_path / "log",
                   max_epochs=3, batch_size=2, load_latest=False,
                   rng=np.random.RandomState(0))


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name.startswith("ThreadPoolExecutor")]


class After:
    def __init__(self, n):
        self.n, self.calls = n, 0

    def __call__(self):
        self.calls += 1
        return self.calls >= self.n


def test_train_stop_ends_at_a_step_without_a_partial_checkpoint(tmp_path, capsys):
    torch.set_num_threads(2)
    tr = _tiny_trainer(tmp_path)
    stop = After(3)
    tr.train(stop=stop)                 # 4 steps an epoch: stops inside epoch 1
    assert stop.calls == 3 and tr.optimizer.count == 3 and tr.epoch == 0
    assert not _prefetch_threads()
    assert not list((tmp_path / "ckpt" / "s").glob("*.pth"))
    assert (tmp_path / "log" / "s" / "stats.jsonl").read_text() == ""
    # across an epoch's end: epoch 1's checkpoint and stats line, none of 2's
    tr = _tiny_trainer(tmp_path / "b")
    tr.train(stop=After(6))
    assert tr.epoch == 1 and tr.optimizer.count == 6 and not _prefetch_threads()
    assert [c.name for c in (tmp_path / "b" / "ckpt" / "s").glob("*.pth")] == ["s_ep0001.pth"]
    assert len((tmp_path / "b" / "log" / "s" / "stats.jsonl").read_text().splitlines()) == 1
    # resumed, the unfinished epoch runs again from its start
    tr.train(stop=After(4))
    assert tr.epoch == 2 and tr.optimizer.count == 10
    # without `stop`, whole epochs as before
    tr = _tiny_trainer(tmp_path / "c")
    tr.max_epochs = 1
    tr.train()
    assert tr.epoch == 1 and tr.optimizer.count == 4 and not _prefetch_threads()
    assert [c.name for c in (tmp_path / "c" / "ckpt" / "s").glob("*.pth")] == ["s_ep0001.pth"]
    assert "s done" in capsys.readouterr().out


def test_train_spans_and_counters_only_inside_recording(tmp_path):
    torch.set_num_threads(2)
    profiling.reset()
    tr = _tiny_trainer(tmp_path)
    tr.train(stop=After(2))             # epoch 1: every sample a miss
    assert profiling.spans() == [] and profiling.counts() == {}
    with profiling.recording():
        tr.train(stop=After(3))         # epoch 1 again: every sample a hit
    try:
        got = profiling.spans()
        counts = profiling.counts()
        first = profiling.counts({next(s.request for s in got if s.name == "train_step")})
    finally:
        profiling.reset()
    names = [s.name for s in got]
    steps = [s for s in got if s.name == "train_step"]
    assert len(steps) == 3 and len({s.request for s in steps}) == 3
    assert all(s.request.startswith("train_step#") for s in steps)
    for name in ("tmodel_load", "forward", "backward", "step"):
        inner = [s for s in got if s.name == name]
        assert len(inner) == 3, name
        assert [s.request for s in inner] == [s.request for s in steps], name
        assert all(got[s.parent].name in ("train_step", "forward") for s in inner)
    waits = [s for s in got if s.name == "data_wait"]
    assert len(waits) == 3 and all(s.request is None and s.parent == -1 for s in waits)
    assert names.index("data_wait") < names.index("train_step")
    # every sample seen is a hit or a miss; only the 4 not solved before miss
    assert counts["tmodel_hits"] + counts["tmodel_misses"] == 3 * 2
    assert counts["tmodel_misses"] <= 4
    assert first["tmodel_hits"] + first["tmodel_misses"] == 2
