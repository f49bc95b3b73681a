"""The tracking driver: one run of a tracking cell.

Set-up (counted in setup_s): the weights on the card from the
configuration's weight seed (the same in every run), the refiner's head
scaled on the reference's decode of a calibration frame, the port's fused
tracker built on them, the mix's frames from --seed, and a warm-up of
run_dataset on one short sequence for each (objects, last extract chunk)
pair of the mix: every shape the window meets (a full and the last extract
chunk, a full and the last window of each object count, the init of each
object count, the PNG writer).

The window: the port's own loop, BatchedSequenceTracker.run_dataset (the
CLI's unpipelined loop: uploads, augment, init, tracking, label download,
PNG writes into TMPDIR), on successive chunks of the seeded walk until
`seconds` have passed. fps is every frame of every sequence tracked
over the window's whole time. Each run_sequence is wrapped to keep its labels
and fps.

The check, once the window has closed and the peak memory is read: the
tracker is freed, and the reference (benchmark/reference/, float32, TF32 off,
its own weights made again) tracks a sample of the window's sequences from
the same generated frames, compares the memory and re-solve captured in the
window, and follows the window after that re-solve (check.py).

With `trace`, the tracker's `profile` synchronises at its phase edges (the
phase seconds then hold the device's work), the kernels' launches are timed
with CUDA events, the benchmark's host spans are kept, and torch.profiler
records the device over the window's sequences 2-4.
"""
import contextlib
import dataclasses
import gc
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..rooflines import frtm_model
from . import check, spans
from . import weights as wt
from .core import CellRun
from .traffic import GeneratedSequence, make_all, walk

# the calibration clip's table index, outside every mix's
CALIBRATION_INDEX = 1 << 20
# the traced run's profiler: from the start of the window's sequence 1 to the
# start of its sequence 4 (0-based), or the window's end
PROFILED = (1, 4)


class Dataset(list):
    name = "generated"


def tracker_configs(config: dict):
    """(the port's TrackerConfig, the reference's) with the file's values;
    this driver runs the fused tracker alone."""
    if config["engine"] != "fused":
        raise ValueError(f"engine {config['engine']!r}: the tracking driver runs 'fused'")
    from frtm_tpu_torch import config as port_config
    from ..reference import config as ref_config
    out = []
    for mod in (port_config, ref_config):
        cfg = mod.eval_config(config["arch"], fast=config["fast"], num_aug=config["num_aug"],
                              compute_dtype=config["compute_dtype"])
        disc = dataclasses.replace(
            cfg.disc, init_iters=tuple(config["init_iters"]),
            update_iters=tuple(config["update_iters"]), memory_size=config["memory_size"],
            c_channels=config["c_channels"], train_skipping=config["train_skipping"],
            layer=config["layer"], pixel_weighting_method=config["pixel_weighting"],
            solver=config["solver"])
        out.append(dataclasses.replace(cfg, disc=disc,
                                       refnet_layers=tuple(config["refnet_layers"]),
                                       refnet_channels=config["refnet_channels"]))
    return out


def make_weights(config: dict, device):
    """(backbone state, refiner state, target-model start, refiner channels),
    from the configuration's weight seed."""
    from ..reference.resnet import RESNET_SPECS, resnet_out_channels
    arch, seed = config["arch"], int(config["weight_seed"])
    bsd = wt.backbone_state(arch, seed, device, lambda a: RESNET_SPECS[a][0])
    ch = {L: c for L, c in resnet_out_channels(arch).items() if L in config["refnet_layers"]}
    rsd = wt.refiner_state(ch, config["refnet_channels"], seed, device)
    disc0 = wt.disc_start(resnet_out_channels(arch)[config["layer"]], config["c_channels"],
                          seed, device)
    return bsd, rsd, disc0, ch


def reference_modules(config, bsd, rsd, ch, device):
    from ..reference.resnet import ResNet
    from ..reference.seg_network import SegNetwork
    with torch.device("meta"):
        backbone = ResNet(config["arch"])
        refiner = SegNetwork(ch, 1, config["refnet_channels"])
    backbone.load_state_dict(bsd, assign=True)
    refiner.load_state_dict(rsd, assign=True)
    return backbone.to(device), refiner.to(device)


@torch.no_grad()
def head_statistics(config, rcfg, backbone, refiner, disc0, mix, device):
    """Median and standard deviation of the reference's logits on frame 1 of
    a calibration clip (one object, of the size of the mix's first, made
    from the weight seed), its target model solved on frame 0 alone."""
    from ..reference.discriminator import DiscParams, disc_apply, disc_init, repeat_params
    size = tuple(mix["frame_size"])
    seq = GeneratedSequence({"name": "calibration", "frames": 2,
                             "objects": mix["sequences"][0]["objects"][:1]}, size,
                            int(config["weight_seed"]),
                            CALIBRATION_INDEX)
    im = torch.from_numpy(seq.frames()).to(device).permute(0, 3, 1, 2)
    layers = tuple(config["refnet_layers"])
    feats = backbone.extract_features(im, output_layers=set(layers) | {config["layer"]})
    mask = torch.from_numpy((seq.first_labels() == 1).astype(np.float32)).to(device)
    params, _ = disc_init(repeat_params(DiscParams(*disc0), 1),
                          feats[config["layer"]][0:1][None], mask[None, None, None], rcfg.disc)
    scores, _ = disc_apply(params, feats[config["layer"]][1:2])
    logits = refiner.apply(scores, {L: feats[L][1:2] for L in layers}, size, layers=layers)
    return float(logits.median()), float(logits.std())


def port_tracker(cfg, config, bsd, rsd, disc0, ch, device, profile):
    from frtm_tpu_torch.models.resnet import ResNet
    from frtm_tpu_torch.models.seg_network import SegNetwork
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    with torch.device("meta"):
        backbone = ResNet(config["arch"])
        refiner = SegNetwork(ch, 1, config["refnet_channels"], use_bn=True)
    backbone.load_state_dict(bsd, assign=True)
    refiner.load_state_dict(rsd, assign=True)
    return BatchedSequenceTracker(cfg, backbone, refiner, extract_chunk=config["extract_chunk"],
                                  device=device, disc_params0=disc0, profile=profile)


def warmup_sequences(mix, size, seed, chunk: int):
    """One short sequence for each (objects, frames of the last extract
    chunk) pair of the mix, with the object sizes of the first table entry
    that has it: 1 + r frames, which meets an extract chunk of r, the same
    last window as the entry, and the init of as many objects. For each
    object count the pair of the largest r takes chunk frames more, so that
    a full extract chunk and a full window are met too (chunk is a multiple
    of the window)."""
    first = {}
    for i, s in enumerate(mix["sequences"]):
        first.setdefault((len(s["objects"]), (s["frames"] - 2) % chunk + 1), i)
    longest = {}
    for n, r in first:
        longest[n] = max(longest.get(n, 0), r)
    out = []
    for (n, r), i in sorted(first.items()):
        spec = {"name": f"warmup{n}.{r}", "frames": 1 + r + (chunk if r == longest[n] else 0),
                "objects": mix["sequences"][i]["objects"]}
        out.append(GeneratedSequence(spec, size, seed, i))
    return out


class Recorder:
    """Wraps the tracker's run_sequence: each sequence's frames, objects,
    fps, labels and (profiled) phase stats; starts and stops the traced
    run's profiler at sequence boundaries."""

    def __init__(self, tracker, device_trace=None, capture=None, capture_at=0):
        self.tracker = tracker
        self.records = []
        self.device_trace = device_trace
        self.capture, self.capture_at = capture, capture_at
        self._inner = tracker.run_sequence
        tracker.run_sequence = self.run_sequence

    def run_sequence(self, sequence, *args, **kwargs):
        k = len(self.records)
        if self.capture is not None and k == self.capture_at:
            self.capture.arm(k)
        if self.device_trace is not None:
            if k == PROFILED[0]:
                self.device_trace.start()
            elif k == PROFILED[1]:
                self.device_trace.stop()
        outputs, fps = self._inner(sequence, *args, **kwargs)
        self.records.append(dict(sequence=sequence, frames=len(sequence),
                                 objects=len(sequence.obj_ids), fps=fps,
                                 seconds=len(sequence) / fps, labels=outputs,
                                 phases=dict(self.tracker.last_phase_stats)))
        return outputs, fps

    def detach(self):
        del self.tracker.run_sequence


def instrument(tracker, patches, host, kernels):
    """The traced run's wrappers: host spans around the tracker's entry
    points and layers, the PNG writer and the frames' making; kernels 1, 2
    and 3 timed by CUDA events around their launches."""
    from frtm_tpu_torch.models import augmenter
    from frtm_tpu_torch.ops import halo
    from frtm_tpu_torch.ops.kernels import build
    from frtm_tpu_torch.runtime import sequence_tracker
    for attr, name in (("run_sequence", "run_sequence"), ("run_dataset", "run_dataset"),
                       ("_extract_sequence", "extract"), ("_augment_objects", "augment"),
                       ("_init_objects", "disc_init"), ("_window_track", "scan"),
                       ("_scan_track", "scan"), ("prepare_sequence", "prepare_next"),
                       ("_upload_chunks", "upload")):
        host.wrap(patches, tracker, attr, name)
    host.wrap(patches, sequence_tracker, "imwrite_indexed", "png_write")
    host.wrap(patches, GeneratedSequence, "preload", "frames_made")
    kernels.wrap_launch(patches, build)
    kernels.wrap(patches, halo, "pyrup_kernel", "pyrup")
    kernels.wrap(patches, halo, "head_kernel", "conv3x3_cout1")

    def warp_extra(src, H, size, mode="bicubic", nearest_from=None):
        return 1.0 / float(np.linalg.det(np.asarray(H, np.float64)[:2, :2])), tuple(size), mode
    kernels.wrap(patches, augmenter, "warp_affine", "warp_affine", extra=warp_extra)


def device_block(device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(config, mix, limits, seed, seconds, trace, device="cuda", t_start=None, control=False,
        readings=False):
    """One run of the cell. control: the control in the port's place for the
    numbers compared (check.py); readings: for the readings of those numbers
    alone, no warm-up and the frames made as the loader asks (the window's
    times then hold first-seen shapes and the frames' making)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    size = tuple(mix["frame_size"])
    cfg, rcfg = tracker_configs(config)
    notes = []

    bsd, rsd, disc0, ch = make_weights(config, device)
    rb, rr = reference_modules(config, bsd, rsd, ch, device)
    head = head_statistics(config, rcfg, rb, rr, disc0, mix, device)
    del rb, rr
    wt.scale_head(rsd, *head)
    tracker = port_tracker(cfg, config, bsd, rsd, disc0, ch, device, profile=trace)
    del bsd, rsd

    made = None if readings else make_all(mix, seed)
    tmp = Path(tempfile.mkdtemp(prefix="frtm_bench_"))
    patches, host, kernels = spans.Patches(), spans.HostSpans(), spans.KernelCalls()
    device_trace = spans.DeviceTrace() if trace and device.type == "cuda" else None
    try:
        if not readings:
            with contextlib.redirect_stdout(sys.stderr):
                tracker.run_dataset(Dataset(warmup_sequences(mix, size, seed,
                                                             config["extract_chunk"])),
                                    tmp / "warmup")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        if trace:
            instrument(tracker, patches, host, kernels)
        capture = check.StateCapture()
        capture.install(patches)
        # the re-solve checked: the first of one of the window's first
        # sequences (at most three, and within its first chunk), by the seed
        recorder = Recorder(tracker, device_trace, capture,
                            int(seed) % min(3, int(mix["chunk_sequences"])))

        t0 = time.perf_counter()
        setup_s = t0 - t_start
        visits = {}
        with contextlib.redirect_stdout(sys.stderr):
            for chunk in walk(mix, seed):
                seqs = []
                for i in chunk:
                    seqs.append(GeneratedSequence(mix["sequences"][i], size, seed, i,
                                                  visits.get(i, 0), made))
                    visits[i] = visits.get(i, 0) + 1
                tracker.run_dataset(Dataset(seqs), tmp / "window")
                if time.perf_counter() - t0 >= seconds:
                    break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        if device_trace is not None:
            device_trace.stop()
        calls = kernels.read() if trace and device.type == "cuda" else []
    finally:
        patches.restore()
        shutil.rmtree(tmp, ignore_errors=True)
    recorder.detach()
    records = recorder.records
    frames = sum(r["frames"] for r in records)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    dev_block = device_block(device, peak)
    notes.append(f"card {power_limit() if device.type == 'cuda' else 'cpu'}; "
                 f"setup_s {setup_s!r}, window_s {window_s!r}, {len(records)} sequences, "
                 f"{frames} frames, head median {head[0]!r} std {head[1]!r}")

    context = dict(config=config, mix=mix, window_s=window_s, frames=frames,
                   records=records, kernel_calls=calls,
                   flops=window_flops(config, size, records))
    breakdown = {}
    if device_trace is not None and device_trace.t1_ns is not None:
        context.update(device_intervals=device_trace.intervals,
                       trace_window=(device_trace.t0_ns, device_trace.t1_ns),
                       host_spans=host.spans)
        busy, span_s, gaps = idle_gaps(device_trace.intervals, device_trace.t0_ns,
                                       device_trace.t1_ns, host.spans, threading.get_ident())
        dev_block.update(busy_s=busy, window_s=span_s)
        breakdown = {"device_ops": top_ops(device_trace.intervals, device_trace.t0_ns,
                                           device_trace.t1_ns),
                     "idle_gaps": gaps}
        notes.append(kept_records(calls, device_trace))
    if trace:
        notes.append(f"traced fps {frames / window_s!r} (the untraced run's fps is the "
                     f"end-to-end metric; the difference is the tracing's cost)")
        notes.append(f"seq_s_p90 over {len(records)} sequences")

    # the check: free the port's state, then the reference from the seed
    tracker_device = tracker.device
    del tracker
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, more = check.check_tracking(config, rcfg, limits, records, seed, head, tracker_device,
                                        control=control, taken=capture.taken)
    capture.taken = None
    notes.extend(more)
    for r in records:
        r.pop("labels")
        r.pop("sequence")
    return CellRun(end_to_end={"fps": frames / window_s, "setup_s": setup_s},
                   context=context, device=dev_block, checks=checks,
                   attempted=len(records), failed=0, breakdown=breakdown, notes=notes)


def window_flops(config, size, records) -> dict:
    """{"compute": ..., "float32": ...} model FLOPs of the window's sequences."""
    total = {"compute": 0.0, "float32": 0.0}
    for r in records:
        f = frtm_model.sequence_flops(config, size[0], size[1], r["frames"], r["objects"])
        for k in total:
            total[k] += f[k]
    return total


def _union(intervals, t0, t1):
    """Sorted, merged (start, end) of the intervals clipped to [t0, t1]."""
    merged = []
    for _, s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(intervals, t0, t1) -> float:
    return sum(e - s for s, e in _union(intervals, t0, t1)) / 1e9


def idle_gaps(intervals, t0, t1, host_spans, thread=None, top=10):
    """(busy seconds, window seconds, [[host activity, idle seconds], ...]):
    the device's idle time in [t0, t1] outside the union of its intervals,
    each piece of a gap named by the innermost benchmark span that the
    issuing thread (`thread`; any thread where None) had open over it, summed
    by name, the largest first."""
    merged = _union(intervals, t0, t1)
    busy = sum(e - s for s, e in merged) / 1e9
    gaps, prev = [], t0
    for s, e in merged + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    mine = [sp for sp in host_spans if (thread is None or sp[3] == thread)
            and sp[2] > t0 and sp[1] < t1]
    by_name = {}
    for g0, g1 in gaps:
        inside = [sp for sp in mine if sp[1] < g1 and sp[2] > g0]
        cuts = sorted({g0, g1, *(min(max(sp[i], g0), g1) for sp in inside for i in (1, 2))})
        for a, b in zip(cuts, cuts[1:]):
            cover = [sp for sp in inside if sp[1] <= a and sp[2] >= b]
            name = min(cover, key=lambda sp: sp[2] - sp[1])[0] if cover else "outside_spans"
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return busy, (t1 - t0) / 1e9, [[k, v] for k, v in ranked]


def top_ops(intervals, t0, t1, top=10):
    by_name = {}
    for name, s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    return [[k[:120], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


# substrings of each kernel's device function names (csrc/*.cu)
KERNEL_NAMES = {"pyrup": ("pyrup",), "conv3x3_cout1": ("conv3x3_cout1",),
                "warp_affine": ("warp_staged_kernel", "warp_direct_kernel")}


def kept_records(calls, device_trace) -> str:
    """How many of the wrapped kernel calls inside the profiled interval the
    profiler kept a record of: a dropped record reads as idle time."""
    t0, t1 = device_trace.t0_ns, device_trace.t1_ns
    names = [n.lower() for n, s, e in device_trace.intervals if t0 <= s <= t1]
    kept = {k: sum(any(sub in n for sub in subs) for n in names)
            for k, subs in KERNEL_NAMES.items()}
    wrapped = {k: sum(c["kernel"] == k and t0 <= c["t_ns"] <= t1 for c in calls)
               for k in KERNEL_NAMES}
    return (f"profiler kept kernel records {kept} of the wrapped calls {wrapped} over the "
            f"profiled {(t1 - t0) / 1e9!r} s")
