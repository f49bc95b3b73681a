#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port (frtm_tpu_torch) starts and
is right on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, each printing one JSON line:
  1. probe    — CUDA present, a real launch, card name and power limit;
  2. build    — the three CUDA kernels compiled from frtm_tpu_torch/ops/kernels/csrc;
  3. kernels  — each kernel against its plain PyTorch version on the card at
                the main path's shapes (max abs difference within the stated
                tolerance), with CUDA-event times of kernel, plain version and
                the one PyTorch call computing the same function; the warp
                rows name the variant they took (staged or direct), and the
                phase gives the launch floor (a one-element zero_());
  4. decode   — one full seg_network_apply at 480x854, kernels against plain
                (its logits also set the scale of the random refiner's head,
                so that the masks hold both classes);
  5. main     — the rn101 eval configuration (seeded random weights) tracking
                one object through a synthetic 17-frame 480x854 sequence with
                Tracker.run_sequence; launch counts of every kernel (every warp
                must take the staged variant), per-phase seconds, peak memory,
                finiteness;
  6. small    — a 6-frame 96x128 rn18 sequence through the port on the CPU
                (plain versions) and on the card (kernels); masks must agree,
                and each run must re-solve its filter twice.
Then a {"kernels": [...]} line (one entry per kernel) and, last, the
{"ok": true, "device": ...} line. Any failure exits non-zero before it.
Without CUDA, or without the frtm_tpu_torch package beside this file, the
script exits non-zero and prints no result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the f32
# rate of the CUDA cores (no tensor cores). The bound of a kernel is the
# larger of bytes / bandwidth and flops / rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Standard deviation of frame 1's logits after scale_head.
HEAD_SPREAD = 2.0

# (name, TPU kernel it replaces, port source)
KERNEL_INFO = {
    "pyrup": ("frtm_tpu/ops/pallas/pyrup.py:74",
              "frtm_tpu_torch/ops/kernels/csrc/pyrup.cu"),
    "conv3x3_cout1": ("frtm_tpu/ops/pallas/conv_small.py:53",
                      "frtm_tpu_torch/ops/kernels/csrc/conv3x3_cout1.cu"),
    "warp_affine": ("frtm_tpu/ops/pallas/warp.py:167",
                    "frtm_tpu_torch/ops/kernels/csrc/warp_affine.cu"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def event_ms(fn, batch=20, repeats=5, warmup=3):
    """Milliseconds per call from CUDA events around batches of back-to-back
    calls (median over batches, after warm-up). Where the host issues calls
    more slowly than the card runs them, this is the host's issue time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(repeats):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(batch):
            fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / batch


def device_ms(fn, iters=20):
    """Milliseconds of device (kernel) time per call, summed over the
    kernels one call launches, from torch.profiler's CUDA activity; None
    where the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            total_us += getattr(ev, "device_time", None) or getattr(ev, "cuda_time", 0.0)
    return total_us / iters / 1e3 if total_us > 0 else None


def cuda_ms(fn):
    """(ms, method): device time per call where the profiler gives it, else
    the CUDA-event time per call."""
    d = device_ms(fn)
    return (d, "profiler_device_time") if d is not None else (event_ms(fn), "cuda_events")


def warp_source_pixels(M, src_hw, size, mode):
    """Source pixels a warp must read: the in-range taps of every output
    pixel (1, 4 or 16 per pixel), counted once each. The map is the kernel's
    own (the float32 inverse_coefficients of M, evaluated in float64)."""
    from frtm_tpu_torch.ops.warp import inverse_coefficients
    h = torch.tensor(inverse_coefficients(M), dtype=torch.float32, device="cuda").double()
    yo, xo = torch.meshgrid(torch.arange(size[0], device="cuda", dtype=torch.float64),
                            torch.arange(size[1], device="cuda", dtype=torch.float64),
                            indexing="ij")
    w = h[6] * xo + h[7] * yo + h[8]
    xs, ys = (h[0] * xo + h[1] * yo + h[2]) / w, (h[3] * xo + h[4] * yo + h[5]) / w
    if mode == "nearest":
        xs, ys, offsets = torch.floor(xs + 0.5), torch.floor(ys + 0.5), [0]
    else:
        xs, ys = torch.floor(xs), torch.floor(ys)
        offsets = [0, 1] if mode == "bilinear" else [-1, 0, 1, 2]
    H, W = src_hw
    read = torch.zeros(H * W, dtype=torch.bool, device="cuda")
    for dy in offsets:
        for dx in offsets:
            x, y = (xs + dx).long(), (ys + dy).long()
            ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            read[(y * W + x)[ok]] = True
    return int(read.sum())


def inverse_grid(M, size, src_hw):
    """F.grid_sample's grid (align_corners=True) for the warp by the forward
    matrix M: the kernel's own inverse map over the output size, in the
    source's normalised coordinates."""
    from frtm_tpu_torch.ops.warp import inverse_coefficients
    h = [float(v) for v in inverse_coefficients(M)]
    yo, xo = torch.meshgrid(torch.arange(float(size[0]), device="cuda"),
                            torch.arange(float(size[1]), device="cuda"), indexing="ij")
    w = h[6] * xo + h[7] * yo + h[8]
    return torch.stack([(h[0] * xo + h[1] * yo + h[2]) / w / (src_hw[1] - 1) * 2 - 1,
                        (h[3] * xo + h[4] * yo + h[5]) / w / (src_hw[0] - 1) * 2 - 1], -1)[None]


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------


def phase_probe():
    x = torch.arange(1 << 20, device="cuda", dtype=torch.float32)
    s = float((x * 2).sum())
    torch.cuda.synchronize()
    if s != float(2 * sum(range(1 << 20))):
        fail(f"probe: device sum {s} is wrong")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "probe", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def phase_build():
    from frtm_tpu_torch.ops.kernels import build as kbuild
    seconds = kbuild.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in kbuild.BUILD_LOG.items()}
    spill_free = {n: all(" 0 bytes spill stores, 0 bytes spill loads" in ln
                         for ln in lines if "spill" in ln)
                  for n, lines in ptxas.items()}
    emit({"phase": "build", "seconds": seconds, "kernels": list(kbuild.KERNELS),
          "ptxas": ptxas, "spill_free": spill_free})


def _compare(name, shape, kernel_fn, plain_fn, library_fn, nbytes, flops, tol):
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name} {shape}: kernel shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    if not np.isfinite(err) or err > tol:
        fail(f"{name} {shape}: max abs difference {err} over tolerance {tol}")
    b, by = bound_ms(nbytes, flops)
    ms, method = cuda_ms(kernel_fn)
    library_ms = None if library_fn is None else cuda_ms(library_fn)[0]
    return {"shape": shape, "max_abs_err": err, "tolerance": tol,
            "ms": ms, "plain_ms": cuda_ms(plain_fn)[0], "library_ms": library_ms,
            "library_ratio": None if library_ms is None else ms / library_ms,
            "bound_share": b / ms, "ms_method": method, "event_ms": event_ms(kernel_fn),
            "bound_ms": b, "bound_by": by}


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F
    from frtm_tpu_torch.ops.kernels import (
        VARIANTS, pyr_up_bicubic, pyr_up_bicubic_plain, conv3x3_cout1, conv3x3_cout1_plain,
        warp_affine)
    from frtm_tpu_torch.ops.warp import inverse_coefficients, warp_affine_plain

    g = torch.Generator(device="cpu").manual_seed(0)
    rows = {}
    # the least device time of a kernel launch: one float zeroed
    one = torch.empty(1, device="cuda")
    launch_floor_ms = device_ms(lambda: one.zero_())

    # kernel 1: the decoder's two pyrup stages (exact: same op order), at
    # N=1 and at N=8, the fused tracker's decode window
    stages = []
    for shape in [(1, 32, 120, 214), (1, 16, 240, 428), (8, 32, 120, 214), (8, 16, 240, 428)]:
        x = torch.randn(shape, generator=g).cuda()
        n_out = 4 * x.numel()
        stages.append(_compare(
            "pyrup", list(shape), lambda x=x: pyr_up_bicubic(x),
            lambda x=x: pyr_up_bicubic_plain(x),
            lambda x=x: F.interpolate(x, scale_factor=2, mode="bicubic",
                                      align_corners=False),
            nbytes=4 * (x.numel() + n_out), flops=35 * n_out, tol=0.0))
    rows["pyrup"] = stages

    # kernel 2: the head conv, (N, 16, 480, 854) -> 1, with bias, at N=1 and 8
    w = (torch.rand(1, 16, 3, 3, generator=g) * 0.2 - 0.1).cuda()
    b = (torch.rand(1, generator=g) * 0.2 - 0.1).cuda()
    convs = []
    for n in (1, 8):
        x = torch.relu(torch.randn(n, 16, 480, 854, generator=g)).cuda()
        convs.append(_compare(
            "conv3x3_cout1", [n, 16, 480, 854], lambda x=x: conv3x3_cout1(x, w, b),
            lambda x=x: conv3x3_cout1_plain(x, w, b),
            lambda x=x: F.conv2d(x, w, b, padding=1),
            nbytes=4 * (x.numel() + n * 480 * 854 + w.numel() + 1),
            flops=2 * 9 * x.numel(), tol=5e-5))
        del x
    rows["conv3x3_cout1"] = convs

    # kernel 3: a full-frame background warp (bicubic, 3 planes, rotated),
    # the eval augmenter's own background (scale 1.2 about the frame centre,
    # no rotation), a foreground RGBA sub-box (bicubic) and its label
    # (nearest, float32 0/1 planes, as the augmenter passes them), and the
    # augmenter's worst footprint: an RGBA target at 45 degrees and scale 0.5
    # (inverse step 2)
    T = np.array([[1.2 * np.cos(0.3), 1.2 * np.sin(0.3), -60.0],
                  [-1.2 * np.sin(0.3), 1.2 * np.cos(0.3), 90.0], [0, 0, 1]])
    Te = np.array([[1.2, 0, 427.0 - 1.2 * 427.0], [0, 1.2, 240.0 - 1.2 * 240.0], [0, 0, 1]])
    img = (torch.rand(3, 480, 854, generator=g) * 255).cuda()
    rgba = (torch.rand(4, 480, 854, generator=g) * 255).cuda()
    lbl = (torch.rand(1, 480, 854, generator=g) > 0.5).float().cuda()
    Ts = np.array([[1, 0, -300.0], [0, 1, -150.0], [0, 0, 1]]) @ T
    a = np.deg2rad(45)
    Tw = (np.array([[1, 0, 120.0], [0, 1, 100.0], [0, 0, 1]])
          @ np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]])
          @ np.diag([0.5, 0.5, 1.0]) @ np.array([[1, 0, -427.0], [0, 1, -240.0], [0, 0, 1]]))
    warps = []
    for label, src, M, size, mode in [
            ("background", img, T, (480, 854), "bicubic"),
            ("background_eval", img, Te, (480, 854), "bicubic"),
            ("foreground", rgba, Ts, (200, 240), "bicubic"),
            ("label", lbl, Ts, (200, 240), "nearest"),
            ("foreground_worst", rgba, Tw, (200, 240), "bicubic")]:
        n_out = src.shape[0] * size[0] * size[1]
        n_read = src.shape[0] * warp_source_pixels(M, src.shape[1:], size, mode)
        taps = {"nearest": 1, "bilinear": 4, "bicubic": 16}[mode]
        # the library call: grid_sample on the kernel's own map (its nearest
        # rounds halves to even where the kernel takes floor(x + 0.5))
        grid = inverse_grid(M, size, src.shape[1:])
        lib = lambda src=src, grid=grid, mode=mode: F.grid_sample(
            src[None], grid, mode=mode, padding_mode="zeros", align_corners=True)
        row = _compare(
            "warp_affine", [src.shape[0], 480, 854, mode, list(size)],
            lambda src=src, M=M, size=size, mode=mode: warp_affine(src, M, size, mode),
            lambda src=src, M=M, size=size, mode=mode: warp_affine_plain(
                src, inverse_coefficients(M), size, mode),
            lib, nbytes=src.element_size() * (n_read + n_out),
            flops=n_out * (2 * taps + 20), tol=0.0)
        before = dict(VARIANTS["warp_affine"])
        warp_affine(src, M, size, mode)
        row["variant"] = [v for v, n in VARIANTS["warp_affine"].items() if n > before[v]][0]
        row["role"] = label
        row["source_values_read"] = n_read
        row["launch_floor_ms"] = launch_floor_ms
        warps.append(row)
    rows["warp_affine"] = warps
    emit({"phase": "kernels", "launch_floor_ms": launch_floor_ms, "rows": rows})
    return rows


class plain_decoder:
    """Within the block, the decoder calls the plain versions of kernels 1
    and 2 (on CUDA tensors too) — for the decode comparison only."""

    def __enter__(self):
        from frtm_tpu_torch.models import seg_network as sn
        from frtm_tpu_torch.ops.kernels import conv3x3_cout1_plain, pyr_up_bicubic_plain
        self.saved = sn.pyr_up_bicubic, sn.conv3x3_cout1
        sn.pyr_up_bicubic, sn.conv3x3_cout1 = pyr_up_bicubic_plain, conv3x3_cout1_plain

    def __exit__(self, *exc):
        from frtm_tpu_torch.models import seg_network as sn
        sn.pyr_up_bicubic, sn.conv3x3_cout1 = self.saved


def build_models(arch, cfg, device):
    from frtm_tpu_torch.models.resnet import resnet_out_channels
    from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network
    backbone = init_resnet(arch, torch.Generator().manual_seed(1), device=device)
    ch = {L: c for L, c in resnet_out_channels(arch).items() if L in cfg.refnet_layers}
    refiner = init_seg_network(ch, torch.Generator().manual_seed(2),
                               use_bn=cfg.refnet_use_bn, device=device)
    return backbone, refiner


@torch.no_grad()
def frame1_decoder(tracker, seq):
    """The tracker's own target model, solved on frame 0, applied to frame 1:
    returns a function that decodes frame 1's logits with the refiner."""
    from frtm_tpu_torch.models.discriminator import disc_apply
    from frtm_tpu_torch.models.seg_network import seg_network_apply
    cfg = tracker.cfg
    tracker.clear()
    image, labels, new_objects = seq[0]
    tracker.initialize(image, labels, new_objects)
    params = tracker.targets[new_objects[0]].params
    tracker.clear()
    im = torch.from_numpy(seq.images[1]).to(tracker.device).permute(2, 0, 1)[None]
    feats = tracker.backbone.extract_features(im, output_layers=tracker._all_layers)
    scores, _ = disc_apply(params, feats[cfg.disc.layer])
    refnet_feats = {L: feats[L] for L in cfg.refnet_layers}
    size = seq.images[1].shape[:2]
    return lambda: seg_network_apply(tracker.refiner, scores, refnet_feats, size,
                                     layers=cfg.refnet_layers)


@torch.no_grad()
def scale_head(refiner, median, std):
    """Map the head's logits l to (l - median) * spread / std. A random
    refiner's logits span about 0.05 and sit all on one side of 0, so the
    masks would be constant; after this, frame 1's logits have median 0 and
    standard deviation HEAD_SPREAD, and the masks cover about half of the frame
    in the refiner's own pattern, so the updates see both classes."""
    conv2 = refiner.project.conv2
    conv2.weight.mul_(HEAD_SPREAD / std)
    conv2.bias.sub_(median).mul_(HEAD_SPREAD / std)


def logit_stats(logits):
    q = torch.quantile(logits.flatten()[::97], torch.tensor([0.0, 0.5, 1.0],
                                                              device=logits.device))
    return {"quantiles": [float(v) for v in q], "std": float(logits.std()),
            "fg_fraction": float((logits > 0).float().mean())}


def phase_decode(tracker, seq):
    """One full decode at 480x854 with the kernels against the same call
    with their plain versions, on the card; then the head is scaled as in
    scale_head, from the same logits."""
    decode = frame1_decoder(tracker, seq)
    got = decode()
    with plain_decoder():
        want = decode()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = 1e-5 * max(1.0, scale)
    if not np.isfinite(err) or err > tol:
        fail(f"decode: kernels vs plain logits differ by {err} (tolerance {tol})")
    median, std = float(got.median()), float(got.std())
    scale_head(tracker.refiner, median, std)
    emit({"phase": "decode", "logits_shape": list(got.shape), "max_abs_err": err,
          "logit_scale": scale, "tolerance": tol, "head_median": median, "head_std": std,
          "logits_before": logit_stats(got), "logits_after": logit_stats(decode())})


def phase_main(tracker, seq):
    """The main path: Tracker.run_sequence through the rn101 eval config."""
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.models.augmenter import cut_and_inpaint
    from frtm_tpu_torch.ops.kernels import LAUNCHES, VARIANTS, reset_launches

    cfg = tracker.cfg
    # warm-up on a 3-frame sequence (cuDNN algorithm choice, first launches)
    tracker.run_sequence(make_moving_square_sequence(n_frames=3, size=(480, 854),
                                                     square=120, seed=5))
    torch.cuda.synchronize()
    tracker.phase_seconds.clear()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    outputs, fps = tracker.run_sequence(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    warp_variants = dict(VARIANTS["warp_affine"])

    # the host share of "augment": cutting and Telea-inpainting the target once
    t1 = time.perf_counter()
    cut_and_inpaint(seq.images[0], seq.labels[0] == 1)
    host_inpaint_s = time.perf_counter() - t1

    target = tracker.targets[1]
    finite = bool(torch.isfinite(tracker.current_masks).all()
                  and torch.isfinite(target.params.filter).all()
                  and torch.isfinite(target.params.project).all())
    shapes_ok = all(o.shape == seq.images[0].shape[:2] and o.dtype == np.uint8 for o in outputs)
    fg = [int((o == 1).sum()) for o in outputs]
    gt = [int((lb[..., 0] == 1).sum()) for lb in seq.labels]
    inter = [int(((o == 1) & (lb[..., 0] == 1)).sum()) for o, lb in zip(outputs, seq.labels)]
    tracked = len(seq) - 1
    one_class = [i for i, n in enumerate(fg[1:], 1) if n in (0, outputs[i].size)]
    emit({"phase": "main", "arch": cfg.feature_extractor, "frames": len(seq),
          "size": list(seq.images[0].shape[:2]), "fps": fps, "wall_s": wall,
          "phase_seconds": dict(tracker.phase_seconds),
          "host_cut_inpaint_s": host_inpaint_s,
          "launches": launches, "warp_variants": warp_variants,
          "launches_per_tracked_frame": {k: v / tracked for k, v in launches.items()},
          "resolves": target.state.n_resolves,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "finite": finite, "shapes_ok": shapes_ok,
          "fg_pixels": fg, "gt_pixels": gt, "intersection": inter})
    if not (finite and shapes_ok and len(outputs) == len(seq)):
        fail("main: outputs are not finite uint8 label images of the frame size")
    if one_class:
        fail(f"main: tracked frames {one_class} are labelled all one class")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main: kernels never launched on the main path: {missing}")
    if warp_variants["direct"] or warp_variants["staged"] != launches["warp_affine"]:
        fail(f"main: every warp must take the staged kernel, got {warp_variants}")
    if launches["pyrup"] != 2 * tracked or launches["conv3x3_cout1"] != tracked:
        fail(f"main: expected 2 pyrup and 1 head-conv launch per tracked frame, got {launches}")
    if target.state.n_resolves != (len(seq) - 1) // cfg.disc.train_skipping:
        fail(f"main: {target.state.n_resolves} filter re-solves, expected one every "
             f"{cfg.disc.train_skipping} frames")
    return launches


def phase_small(arch="resnet18"):
    """A small sequence through the port twice: on the CPU (plain versions)
    and on the card (kernels, cuDNN), with the head scaled alike from the
    CPU's frame-1 logits; soft masks and labels must agree, and both runs
    must re-solve every train_skipping frames."""
    from dataclasses import replace
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.runtime.tracker import Tracker
    cfg = eval_config(arch, fast=True, num_aug=3)
    cfg = replace(cfg, disc=replace(cfg.disc, init_iters=(3, 5), update_iters=(3,),
                                    memory_size=8, c_channels=16, train_skipping=2))
    seq = make_moving_square_sequence(n_frames=6, size=(96, 128), square=24, seed=2)
    trackers = {dev: Tracker(cfg, *build_models(arch, cfg, dev), device=dev)
                for dev in ("cpu", "cuda")}
    logits = frame1_decoder(trackers["cpu"], seq)()
    median, std = float(logits.median()), float(logits.std())
    masks, resolves = {}, {}
    for dev, tr in trackers.items():
        scale_head(tr.refiner, median, std)
        outs, _ = tr.run_sequence(seq)
        masks[dev] = (tr.current_masks.cpu(), outs)
        resolves[dev] = tr.targets[1].state.n_resolves
    mask_err = float((masks["cpu"][0] - masks["cuda"][0]).abs().max())
    label_diff = max(float(np.mean(a != b)) for a, b in zip(masks["cpu"][1], masks["cuda"][1]))
    expected = (len(seq) - 1) // cfg.disc.train_skipping
    emit({"phase": "small", "arch": arch, "size": [96, 128], "frames": 6,
          "head_median": median, "head_std": std,
          "fg_fraction": [float(np.mean(o == 1)) for o in masks["cuda"][1]],
          "resolves": resolves, "final_mask_max_abs_err": mask_err,
          "label_mismatch_fraction": label_diff,
          "tolerance": {"mask": 1e-2, "labels": 5e-3}})
    if mask_err > 1e-2 or label_diff > 5e-3:
        fail("small: the card's run disagrees with the CPU reference run")
    if any(n != expected for n in resolves.values()):
        fail(f"small: filter re-solves {resolves}, expected {expected} on each device")


def kernels_line(rows, launches):
    """The contract line: one entry per kernel at its main-path shape (pyrup
    stage 2, the head conv, the full-frame background warp)."""
    main_row = {"pyrup": 1, "conv3x3_cout1": 0, "warp_affine": 0}
    out = []
    for name, (replaces, source) in KERNEL_INFO.items():
        r = rows[name][main_row[name]]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "shape": r["shape"], "tolerance": r["tolerance"],
                    "other_shapes": [o for i, o in enumerate(rows[name])
                                     if i != main_row[name]]})
    return {"kernels": out}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke runs on the card only")
    if not (ROOT / "frtm_tpu_torch" / "__init__.py").exists():
        fail(f"frtm_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.runtime.tracker import Tracker
    resolve_device("cuda")     # TF32 off for the whole run

    t0 = time.perf_counter()
    phase_probe()
    phase_build()
    rows = phase_kernels()
    cfg = eval_config("resnet101")
    seq = make_moving_square_sequence(n_frames=17, size=(480, 854), square=120, seed=0)
    tracker = Tracker(cfg, *build_models("resnet101", cfg, "cuda"), device="cuda", profile=True)
    phase_decode(tracker, seq)
    launches = phase_main(tracker, seq)
    del tracker
    phase_small()
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit(kernels_line(rows, launches))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
