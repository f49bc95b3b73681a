"""One run of a training cell, through the port's own
`Trainer.train` loop (frtm_tpu_torch/runtime/trainer.py) as
frtm_tpu_torch/train.py builds it.

Set-up (counted in setup_s): the weights on the card from the
configuration's weight seed (the same in every run, harness/weights.py), the
port's TrainerModel and Trainer on them (train_config with the file's
values), a pool of samples made from --seed in host memory (each entry of
the mix's `sequences` one sample: its frames, one textured ellipse an
entry, its label in every frame), the pool's target models solved by the
trainer's own cold path (`build_disc_batch`, `chunk_sequences` entries at a
time) into a TModelCache under TMPDIR, as epoch 1 of a training run solves
them, and WARMUP_STEPS steps through `Trainer.train(stop=...)`.

The window: `Trainer.train(stop=...)` from epoch 2 (lr 1e-3, every sample
a cache hit, as in epochs 2-260), its epoch `epoch_samples` samples of the
pool drawn by the Trainer's own permutation (RandomState(seed)), prefetch
on, until `seconds` have passed; an epoch's end inside it writes its
checkpoint into TMPDIR. fps is the trained frames (frames 1..T-1 of every
sample) over the window's seconds.

The check, once the window has closed and the peak memory is read: one
window step among the first three, drawn from the seed, is captured on the
timed path (StepCapture); the port's state is freed and the plain
reference (benchmark/reference/trainer.py, float32, TF32 off) recomputes
that step from the captured state (check_step).

With `trace`, the model's PhaseTimer synchronises at its phase edges, the
port's span recorder is on over the window, the kernels' launches (kernels
1 and 2 forward, and their three backward kernels) are timed with CUDA
events, and torch.profiler records the device over window steps
PROFILED[0] to PROFILED[1].
"""
import contextlib
import dataclasses
import gc
import importlib
import inspect
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..rooflines import frtm_train
from . import spans, track
from .check import _rel
from .core import CellRun
from .traffic import _rng, _texture

# the traced run's profiler: from the end of window step 2 to the end of 5
PROFILED = (2, 5)
WARMUP_STEPS = 3
# the refiner's parameters whose exact gradient is 0: the convolution biases
# right before a batch-statistics BatchNorm, which subtracts their effect
ZERO_GRAD_SUFFIX = "bblock.0.bias"


def train_cfg(config: dict):
    """The port's train_config(arch) with the file's values."""
    from frtm_tpu_torch.config import train_aug_params
    from frtm_tpu_torch.train import train_config
    if config["compute_dtype"] != "float32":
        raise ValueError(f"compute_dtype {config['compute_dtype']!r}: the trainer computes "
                         "in float32")
    cfg = train_config(config["arch"])
    disc = dataclasses.replace(
        cfg.disc, c_channels=config["c_channels"], init_iters=tuple(config["init_iters"]),
        update_iters=tuple(config["update_iters"]), memory_size=config["memory_size"],
        train_skipping=config["train_skipping"], layer=config["layer"],
        pixel_weighting_method=config["pixel_weighting"])
    return dataclasses.replace(cfg, disc=disc, num_aug=config["num_aug"],
                               aug_params=train_aug_params(config["num_aug"]),
                               refnet_layers=tuple(config["refnet_layers"]),
                               refnet_channels=config["refnet_channels"])


def make_sample(spec: dict, size, seed: int, index: int):
    """(frames [T x (H, W, 3) uint8], labels [T x (H, W, 1) uint8 in {0,
    1}]) of pool entry `index` under `seed`: traffic.make_frames's scene
    (a textured background, the entry's one ellipse placed in a cell of the
    frame, moving 1-4 px a frame and bouncing off the edges) with the
    object's label in every frame."""
    H, W = size
    rng = _rng(seed, 5, index)
    bg = _texture(rng, H, W, 30, 130, 8)
    h, w = (int(v) for v in spec["objects"][0])
    cx = (int(rng.integers(2)) + 0.5) * W / 2
    pos = [float(np.clip(H / 2 - h / 2, 0, H - h)), float(np.clip(cx - w / 2, 0, W - w))]
    v = rng.uniform(1.0, 4.0, 2) * rng.choice([-1.0, 1.0], 2)
    yy, xx = np.mgrid[:h, :w]
    inside = ((yy + 0.5 - h / 2) / (h / 2)) ** 2 + ((xx + 0.5 - w / 2) / (w / 2)) ** 2 <= 1
    tex = _texture(rng, h, w, 120, 250, 6)
    frames, labels = [], []
    for _ in range(spec["frames"]):
        im, lb = bg.copy(), np.zeros((H, W, 1), np.uint8)
        y0, x0 = int(pos[0]), int(pos[1])
        im[y0:y0 + h, x0:x0 + w][inside] = tex[inside]
        lb[y0:y0 + h, x0:x0 + w, 0][inside] = 1
        frames.append(im)
        labels.append(lb)
        for d, lim in ((0, H - h), (1, W - w)):
            pos[d] += v[d]
            if not 0 <= pos[d] <= lim:
                v[d] = -v[d]
                pos[d] = float(np.clip(pos[d], 0, lim))
    return frames, labels


class Pool:
    """The mix's samples under a seed, with the training datasets' item
    interface: pool[i] -> (frames, labels, encoded SampleSpec), the spec
    (entry name, object 1, frames 0..T-1, frame 0) keying the target-model
    cache."""

    def __init__(self, mix, seed: int):
        from frtm_tpu_torch.data.training_datasets import SampleSpec
        size = tuple(mix["frame_size"])
        self.samples = []
        for i, s in enumerate(mix["sequences"]):
            frames, labels = make_sample(s, size, seed, i)
            spec = SampleSpec(s["name"], 1, frames=list(range(s["frames"])), frame0_id=0)
            self.samples.append((frames, labels, spec.encoded()))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def epoch(self, n: int):
        """A dataset of n samples: item i is the pool's i mod its size."""
        pool = self

        class Epoch:
            def __len__(self):
                return n

            def __getitem__(self, i):
                return pool[int(i) % len(pool)]
        return Epoch()


def port_trainer(cfg, config, datasets, bsd, rsd, disc0, ch, device, tmp: Path, seed, profile):
    """The port's TrainerModel and Trainer, as frtm_tpu_torch/train.py
    builds them, on the benchmark's weights."""
    from frtm_tpu_torch.models.discriminator import DiscParams
    from frtm_tpu_torch.models.resnet import ResNet
    from frtm_tpu_torch.models.seg_network import SegNetwork
    from frtm_tpu_torch.runtime.trainer import TModelCache, Trainer, TrainerModel
    with torch.device("meta"):
        backbone = ResNet(config["arch"])
        refiner = SegNetwork(ch, 1, config["refnet_channels"], use_bn=cfg.refnet_use_bn)
    backbone.load_state_dict(bsd, assign=True)
    refiner.load_state_dict(rsd, assign=True)
    refiner.requires_grad_(True)
    cache = TModelCache(tmp / "tmodels_cache")
    model = TrainerModel(cfg, backbone, refiner, cache, device=device,
                         disc_params0=DiscParams(*disc0), profile=profile)
    return Trainer("bench", model, datasets, checkpoints_path=tmp / "checkpoints",
                   log_path=tmp / "logs", batch_size=int(config["batch_size"]),
                   lr=float(config["lr"]), lr_step=int(config["lr_step"]),
                   weight_decay=float(config["weight_decay"]), load_latest=False,
                   prefetch=True, rng=np.random.RandomState(int(seed) % (1 << 32)))


def fill_cache(model, pool, batch: int):
    """The pool's target models by the trainer's cold path, `batch` entries
    at a time in the table's order, as a cold epoch's batches solve them;
    returns the hits (0 on a fresh cache)."""
    from frtm_tpu_torch.data.training_datasets import SampleSpec
    hits = 0
    for s in range(0, len(pool), batch):
        items = [pool[i] for i in range(s, min(s + batch, len(pool)))]
        _, got = model.build_disc_batch(np.stack([it[0][0] for it in items]),
                                        np.stack([it[1][0] for it in items]),
                                        SampleSpec.from_encoded([it[2] for it in items]))
        hits += got
    return hits


class StepCapture:
    """Wraps the port's TrainerModel.train_step and AMSGrad.step (as the
    Trainer calls them) and keeps, of window step `at` (counted from the
    window's first): before the step, the refiner's state dict, the
    optimizer's state by parameter name, the batch's target models, arrays,
    mask and lr; the gradients as AMSGrad.step is given them; the returned
    loss; after the step, the refiner's state dict and the optimizer's
    moments."""

    def __init__(self, at: int):
        self.at = at
        self.steps = 0
        self.taken = None
        self._open = None

    def install(self, patches):
        from frtm_tpu_torch.runtime import trainer as tr
        inner_step, inner_opt = tr.TrainerModel.train_step, tr.AMSGrad.step
        cap = self

        def train_step(model, disc_batch, images, labels, mask, optimizer, lr, group=None):
            k = cap.steps
            cap.steps += 1
            if k != cap.at:
                return inner_step(model, disc_batch, images, labels, mask, optimizer, lr, group)
            names = [n for n, _ in model.refiner.named_parameters()]
            before = dict(
                state={n: v.detach().clone() for n, v in model.refiner.state_dict().items()},
                opt={"count": optimizer.count,
                     **{key: {n: t.clone() for n, t in zip(names, getattr(optimizer, key))}
                        for key in ("mu", "nu", "nu_max")}},
                weight_decay=optimizer.weight_decay, project=disc_batch.project.clone(),
                filter=disc_batch.filter.clone(), images=images, labels=labels,
                mask=np.array(mask), lr=float(lr), step=k)
            cap._open = (optimizer, names, {})
            stats = inner_step(model, disc_batch, images, labels, mask, optimizer, lr, group)
            cap.taken = dict(before, loss=stats["stats/loss"], grads=cap._open[2],
                             after={n: v.detach().clone()
                                    for n, v in model.refiner.state_dict().items()},
                             opt_after={key: {n: t.clone() for n, t in
                                              zip(names, getattr(optimizer, key))}
                                        for key in ("mu", "nu", "nu_max")})
            cap._open = None
            return stats

        def opt_step(opt, lr):
            if cap._open is not None and opt is cap._open[0]:
                cap._open[2].update({n: p.grad.detach().clone()
                                     for n, p in zip(cap._open[1], opt.params)})
            return inner_opt(opt, lr)
        patches.set(tr.TrainerModel, "train_step", train_step)
        patches.set(tr.AMSGrad, "step", opt_step)


class Window:
    """The `stop` of the window's Trainer.train: counts the steps, starts
    and stops the traced run's profiler at step boundaries, and ends the
    window at the first step boundary after `seconds` once the captured
    step is done."""

    def __init__(self, seconds, capture_at, device_trace=None):
        self.seconds, self.capture_at = seconds, capture_at
        self.device_trace = device_trace
        self.steps = 0
        self.t0 = time.perf_counter()

    def __call__(self):
        self.steps += 1
        if self.device_trace is not None:
            if self.steps == PROFILED[0]:
                self.device_trace.start()
            elif self.steps == PROFILED[1]:
                self.device_trace.stop()
        return (time.perf_counter() - self.t0 >= self.seconds
                and self.steps > self.capture_at)


def instrument(patches, kernels):
    """Kernels 1 and 2 forward (as the decoder calls them) and their
    backward kernels (as their autograd functions call them), each timed by
    CUDA events around its launches."""
    from frtm_tpu_torch.ops import halo
    from frtm_tpu_torch.ops.kernels import build
    # the modules (the package's names of the same spelling are functions)
    pyrup = importlib.import_module("frtm_tpu_torch.ops.kernels.pyrup")
    conv3x3_cout1 = importlib.import_module("frtm_tpu_torch.ops.kernels.conv3x3_cout1")
    kernels.wrap_launch(patches, build)
    kernels.wrap(patches, halo, "pyrup_kernel", "pyrup")
    kernels.wrap(patches, halo, "head_kernel", "conv3x3_cout1")
    kernels.wrap(patches, pyrup, "pyr_up_bicubic_backward", "pyrup_bwd")
    kernels.wrap(patches, conv3x3_cout1, "conv3x3_cout1_input_grad", "conv3x3_cout1_dx")
    kernels.wrap(patches, conv3x3_cout1, "conv3x3_cout1_weight_grad", "conv3x3_cout1_dw")


def stop_supported() -> bool:
    from frtm_tpu_torch.runtime.trainer import Trainer
    return "stop" in inspect.signature(Trainer.train).parameters


def run(config, mix, limits, seed, seconds, trace, device="cuda", t_start=None, control=False,
        readings=False):
    """One run of the cell. control: the control in the port's place for the
    numbers compared (check_step); readings (control.py's): a run for those
    numbers alone, which a training window takes as it is."""
    if not stop_supported():
        raise RuntimeError("this port's Trainer.train takes no `stop`: it cannot run a "
                           "window of a training cell")
    from frtm_tpu_torch.utils import profiling
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cfg = train_cfg(config)
    B, T = int(config["batch_size"]), int(config["sample_frames"])
    n_epoch = int(mix["epoch_samples"])
    if n_epoch % B or any(s["frames"] != T for s in mix["sequences"]):
        raise ValueError(f"the mix's samples must have {T} frames and fill batches of {B}")
    size = tuple(mix["frame_size"])
    notes = []

    bsd, rsd, disc0, ch = track.make_weights(config, device)
    tmp = Path(tempfile.mkdtemp(prefix="frtm_bench_train_"))
    patches, kernels = spans.Patches(), spans.KernelCalls()
    device_trace = spans.DeviceTrace() if trace and device.type == "cuda" else None
    try:
        pool = Pool(mix, seed)
        trainer = port_trainer(cfg, config, [lambda: pool.epoch(n_epoch)], bsd, rsd, disc0, ch,
                               device, tmp, seed, profile=trace)
        del bsd, rsd
        model = trainer.model
        with contextlib.redirect_stdout(sys.stderr):
            cold_hits = fill_cache(model, pool, int(mix["chunk_sequences"]))
            # epoch 1 solved the pool's target models; the window trains in
            # the epochs after it
            trainer.epoch = 1
            trainer.train(stop=Window(0.0, WARMUP_STEPS - 1))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        if trace:
            instrument(patches, kernels)
        capture = StepCapture(int(seed) % 3)
        capture.install(patches)
        window = Window(seconds, capture.at, device_trace)
        profiling.reset()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        window.t0 = t0
        with contextlib.redirect_stdout(sys.stderr), \
                (profiling.recording() if trace else contextlib.nullcontext()):
            trainer.train(stop=window)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        if device_trace is not None:
            device_trace.stop()
        calls = kernels.read() if trace and device.type == "cuda" else []
        program_spans = profiling.spans() if trace else []
        program_counts = profiling.counts() if trace else {}
        profiling.reset()
    finally:
        patches.restore()
    steps = window.steps
    frames = steps * B * (T - 1)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    dev_block = track.device_block(device, peak)
    notes.append(f"card {track.power_limit() if device.type == 'cuda' else 'cpu'}; "
                 f"setup_s {setup_s!r}, window_s {window_s!r}, {steps} steps, {frames} trained "
                 f"frames, epoch {trainer.epoch + 1}, cold-fill hits {cold_hits}, "
                 f"peak {peak} bytes")

    context = dict(config=config, mix=mix, window_s=window_s, steps=steps, frames=frames,
                   kernel_calls=calls, program_spans=program_spans,
                   program_counts=program_counts,
                   flops=steps * frtm_train.step_flops(config, size[0], size[1], B, T))
    breakdown = {}
    if device_trace is not None and device_trace.t1_ns is not None:
        main = threading.get_ident()
        host = [(s.name, s.start_ns, s.end_ns, s.thread) for s in program_spans
                if s.end_ns is not None]
        context.update(device_intervals=device_trace.intervals,
                       trace_window=(device_trace.t0_ns, device_trace.t1_ns))
        busy, span_s, gaps = track.idle_gaps(device_trace.intervals, device_trace.t0_ns,
                                             device_trace.t1_ns, host, main)
        dev_block.update(busy_s=busy, window_s=span_s)
        breakdown = {"device_ops": track.top_ops(device_trace.intervals, device_trace.t0_ns,
                                                 device_trace.t1_ns),
                     "idle_gaps": gaps}
    if trace:
        notes.append(f"traced fps {frames / window_s!r} (the untraced run's fps is the "
                     f"end-to-end metric; the difference is the tracing's cost)")

    # the check: free the port's state, then the reference from the capture
    taken = capture.taken
    del trainer, model, pool
    gc.collect()
    shutil.rmtree(tmp, ignore_errors=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, more = check_step(config, limits, taken, device, control)
    notes.extend(more)
    return CellRun(end_to_end={"fps": frames / window_s, "setup_s": setup_s},
                   context=context, device=dev_block, checks=checks, attempted=steps,
                   failed=0, breakdown=breakdown, notes=notes)


def step_gaps(got: dict, ref: dict, before: dict) -> dict:
    """The four numbers of one side (the port's capture or the control's
    step) against the reference's, each the worst tensor's (Frobenius):
    loss_gap |L - L_ref| / |L_ref|; grad_gap of the gradients; update_gap of
    the step's parameter change and of the optimizer's three moments after
    it (mu, nu, nu_max: the optimizer's order of operations shows in
    nu_max, which a parameter change of a few steps hardly parts); bn_stat_gap
    of the step's change of the running statistics. The parameters whose
    exact gradient is 0
    (ZERO_GRAD_SUFFIX) are left out of grad_gap and update_gap: their
    gradients are rounding noise on either side (1e-9 to 1e-7), a few
    hundredths of their decay term, 1e-5 p, and so is the share of their
    update that the noise moves; the notes print their largest |g|."""
    judged = [k for k in ref["grads"] if not k.endswith(ZERO_GRAD_SUFFIX)]
    return {
        "loss_gap": abs(got["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30),
        "grad_gap": max(_rel(got["grads"][k], ref["grads"][k]) for k in judged),
        "update_gap": max([_rel(got["params"][k] - before[k], ref["params"][k] - before[k])
                           for k in judged]
                          + [_rel(got["opt_state"][m][k], ref["opt_state"][m][k])
                             for m in ("mu", "nu", "nu_max") for k in judged]),
        "bn_stat_gap": max(_rel(got["running"][k] - before[k], ref["running"][k] - before[k])
                           for k in ref["running"])}


def check_step(config, limits, taken, device, control=False):
    """({number: (value, limit)}, notes): the reference's step from the
    captured state against the port's (or, with control, the control's:
    the port's numbers then go into the notes)."""
    from ..reference.resnet import ResNet
    from ..reference import trainer as ref_trainer
    from . import weights as wt
    if taken is None:
        return {k: (None, lim) for k, lim in limits.items()}, ["check: no step was captured"]
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    from ..reference.resnet import RESNET_SPECS
    bsd = wt.backbone_state(config["arch"], int(config["weight_seed"]), device,
                            lambda a: RESNET_SPECS[a][0])
    with torch.device("meta"):
        backbone = ResNet(config["arch"])
    backbone.load_state_dict(bsd, assign=True)
    del bsd
    before = {k: v.to(device) for k, v in taken["state"].items()}
    args = dict(project=taken["project"], filt=taken["filter"], images=taken["images"],
                labels=taken["labels"], mask=taken["mask"], opt_state=taken["opt"],
                lr=taken["lr"], weight_decay=taken["weight_decay"],
                layers=tuple(config["refnet_layers"]), disc_layer=config["layer"],
                device=device)
    ref = ref_trainer.train_step(backbone.to(device), before, **args)
    after = taken["after"]
    port = {"loss": taken["loss"], "grads": taken["grads"],
            "params": {k: after[k] for k in ref["params"]},
            "running": {k: after[k] for k in ref["running"]}, "opt_state": taken["opt_after"]}
    worst = {"port": step_gaps(port, ref, before)}
    if control:
        ctl = ref_trainer.train_step(backbone, before, control=True, **args)
        worst["control"] = step_gaps(ctl, ref, before)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    notes = [f"check step {taken['step']} (count {taken['opt']['count'] + 1}, lr "
             f"{taken['lr']!r}): loss {taken['loss']!r} reference {ref['loss']!r}; "
             f"reference_s {time.perf_counter() - t0!r}, reference peak {peak} bytes"]
    zero = [k for k in ref["grads"] if k.endswith(ZERO_GRAD_SUFFIX)]
    if zero:
        notes.append("check gradients of exact value 0 (largest |g|): port "
                     f"{max(float(taken['grads'][k].abs().max()) for k in zero)!r} reference "
                     f"{max(float(ref['grads'][k].abs().max()) for k in zero)!r}")
    judged = "control" if control else "port"
    if control:
        notes.append("port " + " ".join(f"{k} {worst['port'].get(k)!r}" for k in limits))
    return {k: (worst[judged].get(k), lim) for k, lim in limits.items()}, notes
