#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port (frtm_tpu_torch) starts and
is right on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, each printing one JSON line:
  1. probe    — CUDA present, a real launch, card name and power limit;
  2. build    — the CUDA kernels compiled from frtm_tpu_torch/ops/kernels/csrc: the
                three forward kernels (kernels 1 and 2 hold a float32 and a
                bfloat16 instance each, the bfloat16 ones in sources of their
                own: pyrup_bf16.cu, conv3x3_cout1_bf16.cu) and the float32
                backward kernels of kernels 1 and 2 (pyrup_bwd,
                conv3x3_cout1_dx, conv3x3_cout1_dw); ptxas's registers, shared
                memory and spills of every kernel function;
  2b. native  — the host library (frtm_tpu_torch/utils/csrc/frtm_host.cpp) built
                with the host compiler: its build seconds, the JPEG backend it
                found (libjpeg or nvJPEG) and which headers were there; its
                Telea inpaint equal on every value to the plain Python version
                on a 120 px square hole and a 200x300 hole in a textured 480x854
                frame, the dilation and the PNG unfilter (all five filters on a
                480x854 RGB image, and the committed libpng file) equal to
                theirs; the committed JPEG fixtures decoded to their digests
                (libjpeg-turbo) or within 0.5 dB of their PSNR (another
                decoder), one frame alone and in a batch; times of each;
  3. kernels  — each kernel against its plain PyTorch version on the card at
                the main path's shapes (max abs difference within the stated
                tolerance), with CUDA-event times of kernel, plain version and
                the one PyTorch call computing the same function; kernels 1
                and 2 in float32 and in bfloat16 (half the bytes, so half the
                bound; each bfloat16 row gives its time over the float32 one's
                on the same values, bf16_over_f32), also at YouTube-VOS's
                720x1280 decoder shapes with two lanes; the warp rows name the
                variant they took (staged or direct, for one map or batched),
                among them the mixed launch of the host augmenter's paste (RGBA
                bicubic and label nearest, 200x240) and the batched launches of
                one device-augmenter round at S = 19 (backgrounds, target
                crops, masks at 480x854), each bit-exact, against
                F.grid_sample over the same maps; the phase gives the
                launch floor (a one-element
                zero_()); then each backward kernel at the training shapes
                (N = 16: both pyrup stages, the head conv's dx and its dw and
                db) against its plain backward (autograd of the plain
                forward), within 1e-5 (pyrup, dx) or 1e-4 (dw, db) of the plain
                result's peak, with its time, byte bound and the one PyTorch
                call that computes the same gradient (each row also times the
                kernel with CUDA events, event_ms, beside the profiler's ms;
                pyrup's backward must take its 16-byte loads, variant v4, the
                head conv's input gradient its 8-byte stores, v2 (the row
                also gives its stripe rows and block warps), and its weight
                gradient its 8-byte loads, v2);
  4. decode   — one full seg_network_apply at 480x854, kernels against plain
                (its logits also set the scale of the random refiner's head,
                so that the masks hold both classes); then the same decode in
                bfloat16, kernels against plain, and its gap to float32;
  5. main     — the rn101 eval configuration (seeded random weights) tracking
                one object through a synthetic 17-frame 480x854 sequence with
                Tracker.run_sequence; launch counts of every kernel (every warp
                must take the staged variant), per-phase seconds, peak memory,
                finiteness;
  6. fused    — the fused tracker (BatchedSequenceTracker, online merge) on a
                17-frame 480x854 sequence with two objects, same weights, in
                float32: against the host-loop Tracker on the same sequence
                (labels under 0.5 % of pixels apart in every frame, both
                objects in the output), and with the compact augment against
                the dense one; launch counts per run; fps of both engines,
                phase seconds from a synchronised pass, the scan's host waits,
                peak memory, and the device busy share of an unsynchronised
                pass (device time of everything in a torch.profiler trace
                over the wall);
  6b. init_scaling — the fused tracker on 9-frame 480x854 sequences with 1, 2
                and 4 objects: disc_init and scan seconds of a synchronised
                pass, and the kernels each of the two phases ran (a
                torch.profiler session per phase) with the peak memory inside
                it. All objects' target models are solved together, so the
                kernels at four objects may be at most 1.25x those at one;
  6b'. sharded — the multi-sequence engine (ShardedSequenceTracker,
                parallel/multi_sequence.py) in bfloat16 on 17-frame 480x854
                sequences with two objects (seeds 0-3): groups of 1, 2 and 4
                sequences, each sequence's labels against the fused
                tracker's on it alone: within 0.5 % a frame at B = 1, and at
                B = 2 and 4 within twice the fused tracker's own movement
                under a 1e-6 nudge of its init filters, plus 0.5 % (whether
                under 0.5 % is printed); per group one
                decode a window, so 4 bf16 pyrup and 2 bf16 head-conv
                launches a group at every width, 8 staged warps a sequence;
                the kernels of the group's scan (a torch.profiler session) at
                4 sequences at most 1.25x those at 1. Printed: aggregate fps
                per width (three unsynchronised run_sequences passes after a
                warm-up), group_init and group_scan seconds of a synchronised
                pass, peak memory, the card. Then the CLI with --engine
                sharded on 4 sequences x 9 frames, in this process and in two
                processes on the card (RANK 0 and 1, WORLD_SIZE 2, LOCAL_RANK
                0, a free port; `--multihost`, a gloo group): each child
                tracks its round-robin share, the PNGs equal the one
                process's byte for byte, only rank 0 scores, and a child that
                exits non-zero fails the phase;
  6c. device_augment — the device augment backend: DeviceAugmenter on the
                card against the same call on the CPU on a textured 480x854
                frame (visibility counts of every round and labels equal,
                images at most one grey level apart on under 0.1 % of the
                values) and against the host augmenter on the card (the same);
                one round at 4 and at 19 specs must launch the same kernels
                (counted in a child process of its own: late in this
                script torch.profiler loses events), its warps all batched;
                then the fused tracker in bfloat16 (rn101, 480x854, 9
                frames, two objects) with each backend:
                fps of three passes, augment and disc_init seconds of a
                synchronised pass, kernels, launches and peak memory of one
                augment_first_frame, and the share of labels the two
                backends agree on, printed beside its yardstick: the host
                backend's own label movement when the same share of its
                augment values moves by one grey level;
  7. eval     — the evaluation entry point at full width, in bfloat16:
                `frtm_tpu_torch.evaluate.main` with --dev cuda --dtype bfloat16
                --engine fused on a fabricated reference-format .pth and a
                torchvision-format backbone .pth (the same weights, written to
                a temporary directory) over 3 synthetic 480x854 sequences of
                25 frames with two objects, once without and once with
                --pipeline. Checked: the loaded models equal the saved
                tensors; 25 PNGs per sequence that read back (the port's own
                codec) equal to what run_sequence returned; frame 0 equals the
                ground truth; the pipelined run's PNGs equal the others byte
                for byte; both report files, whose dataset means equal
                evaluate_dataset's return; per run 18 pyrup, 9 head-conv and
                24 warp launches (one mixed launch per accepted spec), every
                decode launch the bfloat16 instance, every warp staged; no
                host wait in the scan; a re-run equal.
                Printed: fps per sequence, the average, the pipelined
                aggregate, the host's seconds per phase, and on the first
                sequence, its augment batches made once, fps and phase
                seconds without the augment in bfloat16 and in float32, peak
                memory of each, and the label gap between the two (it fails
                above 5 % of a frame). Then one more CLI run with no dataset
                object: `--davis` names the committed DAVIS-layout tree
                (tests/data/torch_fixtures/davis: JPEG frames, PNG
                annotations, one sequence of 9 480x854 frames, two objects),
                read through DAVISDataset and the host library's decoder;
                checked as above (PNGs, frame 0, reports, launches 2 / 1 /
                8); and once more on that tree with the committed frtm_tpu
                .npz model (tests/data/torch_fixtures/models: a resnet18-width
                refiner, no --backbone), checked alike. Per sequence of every
                run: fps and host_cut_inpaint_s
                (the host's cut and Telea inpaint of every object, timed
                again after the run);
  7b. ytvos   — `frtm_tpu_torch.evaluate_ytvos.main` with --dev cuda --dtype
                bfloat16 on the committed YouTube-VOS-layout tree
                (tests/data/torch_fixtures/ytvos: 9 frames at 720x1280, object 2
                entering at frame 4), the legacy configuration and the
                deferred merge: one PNG per frame, each equal to what was
                tracked; frame 0 the ground truth of object 1, object 2's
                ground truth at its entry frame; a re-run equal byte for byte;
                launches 16 / 8 / 8 (the per-frame loop, 8 decodes of two
                lanes), all bf16 / staged; no host wait in the scan; a decode
                at 720x1280 in bf16, kernels against plain within one ulp.
                Printed: fps, phase seconds, peak memory;
  8. small    — a 6-frame 96x128 rn18 sequence through the port on the CPU
                (plain versions) and on the card (kernels); masks must agree,
                and each run must re-solve its filter twice.
  9. train    — the training entry point at full width:
                `frtm_tpu_torch.train.main` with --dset all --dev cuda
                --batch-size 16 (rn101, 480x854, 15 augmentations, c = 32) on a
                DAVIS-train tree made from the committed DAVIS frames (one
                sequence, two objects: 16 samples per epoch) and a
                YouTube-VOS-train tree made from the committed 720x1280 frames
                under the first jjtrain name (2 samples: the loader's area
                resize), with a fabricated rn101 .pth: 2 epochs of 2 steps
                (the second padded and masked), then --max-epochs 3 to resume.
                Checked: two, then three, stats.jsonl lines with finite loss
                and accuracy; one cache file per distinct miss, hits in epoch
                2; checkpoints ep0001 and ep0002; the resumed run starts at
                epoch 3 from the saved tensors; every refiner parameter moved,
                BN weight and bias included; launches of every forward and
                backward kernel and of the warp, every pyrup backward with
                16-byte loads (v4), every head-conv input gradient with 8-byte
                stores (v2) and every head-conv weight gradient with 8-byte
                loads (v2). Then one train step of rn18
                at 96x128, batch 4, on fixed target models on the CPU (plain
                versions) and on the card (kernels): loss within rtol 1e-4,
                every gradient within 1e-3 of its peak, a second card run
                bit-equal. Printed: seconds per step and samples per second,
                the cold start's augment, extract and disc_init seconds,
                forward and backward seconds of a synchronised step, peak
                memory.
  10. dp_train — data-parallel training (parallel/train_step.py,
                Trainer(mesh=), train --dp / --multihost) at full width:
                rn101, 480x854, train_config, three frames a sample, a
                global batch of 16 (the committed fixtures' DAVIS tree), in
                child processes (`chip_smoke.py --dp-child`). A one-rank
                NCCL world: two steps bit-equal to the meshless trainer
                (losses and refiner), then one epoch of `train.main --dp
                1`. Two gloo ranks on the one card (NCCL refuses two ranks
                a card), 8 rows each, on the one-rank world's target
                models: loss and accuracy within rtol 1e-4 of the one-rank
                step, gradients within twice the one-rank step's own
                movement under a 1e-6 nudge of every refiner weight plus
                1e-3 of their peak, running statistics within 1e-5 of their
                peak, the replicas bit-equal after two AMSGrad steps (the
                second leaves rank 1 only padding); then one epoch of
                `train.main --multihost` in both (its second batch leaves
                rank 1 only padding): finite statistics, checkpoints and
                stats.jsonl from rank 0 only, the ranks' refiners equal.
                Launches a rank a step: 4 / 2 float32 forward, 4 pyrup_bwd
                (v4), 2 head-conv dx and 2 dw (v2), none bf16. Printed:
                step seconds a rank, all-reduce seconds (gradients,
                BatchNorm), peak memory a rank, the card; two ranks sharing
                one card over gloo are not a scaling figure, and two cards
                over NCCL are not measured;
  11. synthetic — scripts/torch_train_eval_synthetic.py --dev cuda at its
                defaults with --compare-dtypes: trains rn18 on synthetic
                scenes and tracks 3 held-out sequences; fails under a mean
                J of SYNTHETIC_MIN_J (frtm_tpu's script's own J less 0.1).
The kernels phase also holds the backward kernels at N = 8 (a rank's rows),
and the native phase the three INTER_AREA paths of the loaders' resize.
Then a {"kernels": [...]} line (one entry per kernel instance, the backward
kernels included) and, last, the
{"ok": true, "device": ...} line. Any failure exits non-zero before it.
Without CUDA, or without the frtm_tpu_torch package beside this file, the
script exits non-zero and prints no result.
"""
import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "data" / "torch_fixtures"

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
    "pyrup_bf16": ("frtm_tpu/ops/pallas/pyrup.py:74",
                   "frtm_tpu_torch/ops/kernels/csrc/pyrup_bf16.cu"),
    "conv3x3_cout1": ("frtm_tpu/ops/pallas/conv_small.py:53",
                      "frtm_tpu_torch/ops/kernels/csrc/conv3x3_cout1.cu"),
    "conv3x3_cout1_bf16": ("frtm_tpu/ops/pallas/conv_small.py:53",
                           "frtm_tpu_torch/ops/kernels/csrc/conv3x3_cout1_bf16.cu"),
    "warp_affine": ("frtm_tpu/ops/pallas/warp.py:167",
                    "frtm_tpu_torch/ops/kernels/csrc/warp_affine.cu"),
    # its launches of S maps (the device augmenter's rounds)
    "warp_affine_batched": ("frtm_tpu/ops/pallas/warp.py:167",
                            "frtm_tpu_torch/ops/kernels/csrc/warp_affine.cu"),
    # the gradients of kernels 1 and 2, which the JAX package takes by
    # autodiff of its XLA decoder
    "pyrup_bwd": ("frtm_tpu/ops/pallas/pyrup.py:74",
                  "frtm_tpu_torch/ops/kernels/csrc/pyrup_bwd.cu"),
    "conv3x3_cout1_dx": ("frtm_tpu/ops/pallas/conv_small.py:53",
                         "frtm_tpu_torch/ops/kernels/csrc/conv3x3_cout1_dx.cu"),
    "conv3x3_cout1_dw": ("frtm_tpu/ops/pallas/conv_small.py:53",
                         "frtm_tpu_torch/ops/kernels/csrc/conv3x3_cout1_dw.cu"),
}
FORWARD_KERNELS = ("pyrup", "conv3x3_cout1", "warp_affine")
BACKWARD_KERNELS = ("pyrup_bwd", "conv3x3_cout1_dx", "conv3x3_cout1_dw")
TRAIN_KERNELS = FORWARD_KERNELS + BACKWARD_KERNELS


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


def cuda_ms(fn, attempts=3):
    """(ms, method): device time per call where the profiler gives it (a
    session that delivers no device event is repeated, up to `attempts`
    sessions), else the CUDA-event time per call."""
    for _ in range(attempts):
        d = device_ms(fn)
        if d is not None:
            return d, "profiler_device_time"
    return event_ms(fn), "cuda_events"


def warp_source_pixels(Ms, src_hw, size, mode):
    """Source pixels a warp by the forward matrices Ms must read: the
    in-range taps (1, 4 or 16 per output pixel) of every map, counted once
    each, however many maps read them (the maps of a batched launch read one
    source). Each map is the kernel's own (the float32 inverse_coefficients
    of M, evaluated in float64)."""
    from frtm_tpu_torch.ops.warp import inverse_coefficients
    H, W = src_hw
    read = torch.zeros(H * W, dtype=torch.bool, device="cuda")
    yo, xo = torch.meshgrid(torch.arange(size[0], device="cuda", dtype=torch.float64),
                            torch.arange(size[1], device="cuda", dtype=torch.float64),
                            indexing="ij")
    for M in Ms:
        h = torch.tensor(inverse_coefficients(M), dtype=torch.float32, device="cuda").double()
        w = h[6] * xo + h[7] * yo + h[8]
        xs, ys = (h[0] * xo + h[1] * yo + h[2]) / w, (h[3] * xo + h[4] * yo + h[5]) / w
        if mode == "nearest":
            xs, ys, offsets = torch.floor(xs + 0.5), torch.floor(ys + 0.5), [0]
        else:
            xs, ys = torch.floor(xs), torch.floor(ys)
            offsets = [0, 1] if mode == "bilinear" else [-1, 0, 1, 2]
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


def demangle(names):
    """C++ names demangled by c++filt where it is there, else as given."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
    except OSError:
        return list(names)
    return out if len(out) == len(names) else list(names)


def ptxas_functions(log):
    """[{function, registers, smem_bytes, spill_store_bytes,
    spill_load_bytes}] of every kernel function in one `nvcc -Xptxas=-v`
    output, names demangled."""
    funcs = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            funcs.append({"function": m.group(1)})
        elif funcs and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            funcs[-1]["spill_store_bytes"], funcs[-1]["spill_load_bytes"] = map(int, m.groups())
        elif funcs and "Used" in ln and "registers" in ln:
            funcs[-1]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            funcs[-1]["smem_bytes"] = int(smem.group(1)) if smem else 0
    for f, name in zip(funcs, demangle([f["function"] for f in funcs])):
        f["function"] = name
    return funcs


def phase_build():
    """Builds every kernel source; returns ptxas's readings by source."""
    from frtm_tpu_torch.ops.kernels import build as kbuild
    seconds = kbuild.build()
    ptxas = {n: ptxas_functions(log) for n, log in kbuild.BUILD_LOG.items()}
    spill_free = {n: all(f.get("spill_store_bytes", 1) == 0 and f.get("spill_load_bytes", 1) == 0
                         for f in funcs)
                  for n, funcs in ptxas.items()}
    emit({"phase": "build", "seconds": seconds, "kernels": list(kbuild.KERNELS),
          "sources": list(kbuild.SOURCES), "ptxas": ptxas, "spill_free": spill_free})
    return ptxas


def host_ms(fn, repeats=5):
    """Median host milliseconds of one call."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def textured_frame(size, seed=0):
    """(H, W, 3) uint8 with texture at several scales: smoothed noise and
    a sinusoidal pattern."""
    rng = np.random.RandomState(seed)
    H, W = size
    img = rng.rand(H, W, 3) * 255
    for _ in range(3):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1) + np.roll(img, -1, 0)
               + np.roll(img, -1, 1)) / 5
    yy, xx = np.mgrid[0:H, 0:W]
    pattern = 40 * np.sin(xx / 9.0)[..., None] * np.cos(yy / 13.0)[..., None]
    return np.clip(img * 2 - 127 + pattern, 0, 255).astype(np.uint8)


def png_rows(arr, ftypes):
    """The raw (inflated) PNG image data of (h, w, c) uint8 `arr` with row y
    filtered by ftypes[y % len(ftypes)]: the encoder's side of the unfilter,
    vectorised over each row (the predictors read the unfiltered values)."""
    h, w, c = arr.shape
    cur = arr.reshape(h, w * c).astype(np.int64)
    up = np.concatenate([np.zeros((1, w * c), np.int64), cur[:-1]])
    left = np.concatenate([np.zeros((h, c), np.int64), cur[:, :-c]], axis=1)
    upleft = np.concatenate([np.zeros((h, c), np.int64), up[:, :-c]], axis=1)
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = {0: 0 * cur, 1: left, 2: up, 3: (left + up) // 2, 4: paeth}
    types = np.array([ftypes[y % len(ftypes)] for y in range(h)])
    rows = np.stack([((cur[y] - preds[types[y]][y]) % 256) for y in range(h)]).astype(np.uint8)
    return np.concatenate([types[:, None].astype(np.uint8), rows], axis=1).tobytes()


def fixture_script():
    """scripts/make_torch_jpeg_fixtures.py, which rebuilds the fixtures'
    source frames with numpy alone."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_jpeg_fixtures", ROOT / "scripts" / "make_torch_jpeg_fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_native():
    """The host library: build, backend, Telea / dilation / unfilter against
    their plain versions, the JPEG fixtures against their manifest."""
    import hashlib
    from frtm_tpu_torch.data import image as port_image
    from frtm_tpu_torch.models.inpaint import (dilate_ellipse2, dilate_ellipse2_plain,
                                               inpaint_telea, inpaint_telea_plain)
    from frtm_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    backend = native.JPEG_BACKEND
    functions = {}

    # Telea, as the augmenter calls it (radius 1), on the full frame
    frame = textured_frame((480, 854))
    telea = []
    for y0, x0, h, w in ((180, 367, 120, 120), (140, 277, 200, 300)):
        mask = np.zeros((480, 854), np.uint8)
        mask[y0:y0 + h, x0:x0 + w] = 1
        got = inpaint_telea(frame, mask, 1)
        t1 = time.perf_counter()
        want = inpaint_telea_plain(frame, mask, 1)
        plain_s = time.perf_counter() - t1
        equal = bool(np.array_equal(got, want))
        telea.append({"hole": [h, w], "equal": equal, "ms": host_ms(lambda: inpaint_telea(
            frame, mask, 1)), "plain_ms": plain_s * 1e3,
            "values_differing": int((got != want).sum())})
        if not equal:
            fail(f"native: C++ Telea differs from the plain version on a {h}x{w} hole on "
                 f"{telea[-1]['values_differing']} values")
    functions["inpaint_telea_u8c3 (200x300 hole, 480x854)"] = {
        "ms": telea[1]["ms"], "plain_ms": telea[1]["plain_ms"]}

    hole = (frame[..., 0] > 200).astype(np.uint8)
    if not np.array_equal(dilate_ellipse2(hole), dilate_ellipse2_plain(hole)):
        fail("native: the dilation differs from the plain version")
    functions["dilate_ellipse2_u8 (480x854)"] = {
        "ms": host_ms(lambda: dilate_ellipse2(hole)),
        "plain_ms": host_ms(lambda: dilate_ellipse2_plain(hole))}

    # the PNG unfilter: Average and Paeth rows (the ones the plain version
    # walks in Python), then all five, on a 480x854 RGB image
    png = {}
    for name, ftypes in (("average_paeth", (3, 4)), ("all_five", (0, 1, 2, 3, 4))):
        raw = png_rows(frame, ftypes)
        got = native.png_unfilter(raw, 480, 854 * 3, 3)
        t1 = time.perf_counter()
        want = port_image._unfilter_plain(raw, 480, 854 * 3, 3)
        plain_ms = (time.perf_counter() - t1) * 1e3
        if not (np.array_equal(got, want) and np.array_equal(got.reshape(480, 854, 3), frame)):
            fail(f"native: the PNG unfilter ({name}) differs from the plain version")
        png[name] = {"ms": host_ms(lambda: native.png_unfilter(raw, 480, 854 * 3, 3)),
                     "plain_ms": plain_ms}
    functions["png_unfilter (480x854 RGB, Average / Paeth rows)"] = png["average_paeth"]

    # the committed fixtures: digests of PIL's decode where the backend is
    # libjpeg-turbo, else the PSNR against the rebuilt source within 0.5 dB
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    script = fixture_script()
    exact = backend.startswith("libjpeg-turbo")
    jpegs, worst_db = {"checked": 0, "digest_equal": 0}, 0.0
    for name, entry in manifest["jpeg"].items():
        got = port_image.imread(FIXTURES / name)
        if list(got.shape) != entry["shape"]:
            fail(f"native: {name} decodes to {got.shape}, expected {entry['shape']}")
        same = hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
        db = script.psnr(got, script.source_of(name))
        worst_db = max(worst_db, abs(db - entry["psnr_db"]))
        jpegs["checked"] += 1
        jpegs["digest_equal"] += same
        if exact and not same:
            fail(f"native: {name} decoded by {backend} differs from PIL's decode")
        if abs(db - entry["psnr_db"]) > 0.5:
            fail(f"native: {name} decodes to {db:.3f} dB against its source, the manifest "
                 f"says {entry['psnr_db']:.3f}")
    jpegs["psnr_gap_db_max"] = worst_db
    for tree, rel in (("davis", "davis/JPEGImages/480p/blobs"),
                      ("ytvos", "ytvos/valid_all_frames/JPEGImages/0a1b2c3d4e")):
        files = sorted((FIXTURES / rel).glob("*.jpg"))
        h, w = native.jpeg_dims(files[0])
        batch = native.batch_decode_jpeg_files(files, h, w)
        if not all(np.array_equal(batch[i], port_image.imread(f)) for i, f in enumerate(files)):
            fail(f"native: the batch decode of the {tree} frames differs from one at a time")
        jpegs[tree] = {"size": [h, w], "frames": len(files),
                       "ms_per_frame_alone": host_ms(lambda: native.decode_jpeg_file(files[0])),
                       "ms_per_frame_batch": host_ms(
                           lambda: native.batch_decode_jpeg_files(files, h, w)) / len(files)}
    functions["decode_jpeg (480x854)"] = {"ms": jpegs["davis"]["ms_per_frame_alone"],
                                          "plain_ms": None}
    functions["batch_decode_jpeg_files (720x1280, per frame)"] = {
        "ms": jpegs["ytvos"]["ms_per_frame_batch"], "plain_ms": None}
    # the committed file libpng wrote with all five filters, through the
    # library's unfilter and through the plain one
    (name, entry), = manifest["png"].items()
    got = port_image.imread(FIXTURES / name)
    library_unfilter = native.png_unfilter
    native.png_unfilter = port_image._unfilter_plain
    try:
        plain = port_image.imread(FIXTURES / name)
    finally:
        native.png_unfilter = library_unfilter
    if hashlib.sha256(got.tobytes()).hexdigest() != entry["sha256"] \
            or not np.array_equal(got, plain):
        fail(f"native: {name} (libpng, filters {entry['filters']}) does not read to its digest "
             "through both unfilters")
    resizes = resize_checks()
    emit({"phase": "native", "build_seconds": build_s, "jpeg_backend": backend,
          "probe": native.PROBE, "telea": telea, "png_unfilter": png, "jpeg": jpegs,
          "resize": resizes, "functions": functions,
          "tolerance": {"telea": 0, "png": 0, "jpeg": "digest" if exact else "0.5 dB",
                        "resize": 0}})


def resize_checks():
    """The training loaders' INTER_AREA resizes to 480x854 in the host
    library against their plain versions, equal on every value, in each of
    OpenCV's three paths: general (720x1280), resizeAreaFast (960x1708, both
    factors 2) and the linear path where an axis enlarges (240x427 both
    axes, 360x1280 one up and one down); 3 channels and 1."""
    from frtm_tpu_torch.data import resize_host as R
    out = {}
    for src_hw in ((720, 1280), (960, 1708), (240, 427), (360, 1280)):
        path = R.area_path(src_hw, (480, 854))[0]
        frame = textured_frame(src_hw, seed=5)
        for image in (frame, np.ascontiguousarray(frame[..., 1])):
            got, want = R.resize_area(image, (480, 854)), R.resize_area_plain(image, (480, 854))
            key = f"{path} {src_hw[0]}x{src_hw[1]}x{image.shape[2] if image.ndim == 3 else 1}"
            out[key] = {"equal": bool(np.array_equal(got, want)),
                        "ms": host_ms(lambda image=image: R.resize_area(image, (480, 854))),
                        "plain_ms": host_ms(lambda image=image: R.resize_area_plain(
                            image, (480, 854)), repeats=2)}
            if not out[key]["equal"]:
                fail(f"native: resize_area {key} differs from the plain version on "
                     f"{int((got != want).sum())} values")
    return out


def bf16_ulp(peak):
    """The spacing of bfloat16 values at `peak` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(peak)) - 7)


def _compare(name, shape, kernel_fn, plain_fn, library_fn, nbytes, flops, tol):
    """tol: the largest max abs difference allowed, "bf16_ulp" for one
    bfloat16 ulp at the plain version's peak, or ("peak", r) for r times the
    plain version's peak."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name} {shape}: kernel gives {tuple(got.shape)} {got.dtype}, "
             f"plain {tuple(want.shape)} {want.dtype}")
    if tol == "bf16_ulp":
        tol = bf16_ulp(float(want.float().abs().max()))
    elif isinstance(tol, tuple):
        tol = tol[1] * float(want.float().abs().max())
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
    # N=1, at N=8 (the fused tracker's decode window with one object) and at
    # N=16 (with two, the fused and eval phases' batch); then YouTube-VOS's
    # two stages at 720x1280 with two lanes (the ytvos phase's decodes), and
    # in bfloat16 at N=64 (the sharded phase's group of four)
    stages, stages16 = [], []
    for shape in [(1, 32, 120, 214), (1, 16, 240, 428), (8, 32, 120, 214), (8, 16, 240, 428),
                  (16, 32, 120, 214), (16, 16, 240, 428), (2, 32, 180, 320),
                  (2, 16, 360, 640)]:
        x = torch.randn(shape, generator=g).cuda()
        n_out = 4 * x.numel()
        stages.append(_compare(
            "pyrup", list(shape), lambda x=x: pyr_up_bicubic(x),
            lambda x=x: pyr_up_bicubic_plain(x),
            lambda x=x: F.interpolate(x, scale_factor=2, mode="bicubic",
                                      align_corners=False),
            nbytes=4 * (x.numel() + n_out), flops=35 * n_out, tol=0.0))
        # the bfloat16 instance on the same values, rounded: half the bytes,
        # the float32 sums, one rounding at the store, so exact again
        xh = x.to(torch.bfloat16)
        stages16.append(_compare(
            "pyrup_bf16", list(shape), lambda x=xh: pyr_up_bicubic(x),
            lambda x=xh: pyr_up_bicubic_plain(x),
            lambda x=xh: F.interpolate(x, scale_factor=2, mode="bicubic",
                                       align_corners=False),
            nbytes=2 * (x.numel() + n_out), flops=35 * n_out, tol=0.0))
    # the multi-sequence engine's window in bfloat16: four sequences x 8
    # frames x 2 objects, N = 64 (made on the card: 0.4 GB of values)
    gc = torch.Generator(device="cuda").manual_seed(1)
    for shape in [(64, 32, 120, 214), (64, 16, 240, 428)]:
        xh = torch.randn(shape, generator=gc, device="cuda").to(torch.bfloat16)
        n_out = 4 * xh.numel()
        stages16.append(_compare(
            "pyrup_bf16", list(shape), lambda x=xh: pyr_up_bicubic(x),
            lambda x=xh: pyr_up_bicubic_plain(x),
            lambda x=xh: F.interpolate(x, scale_factor=2, mode="bicubic",
                                       align_corners=False),
            nbytes=2 * (xh.numel() + n_out), flops=35 * n_out, tol=0.0))
        del xh
    rows["pyrup"] = stages
    rows["pyrup_bf16"] = stages16

    # kernel 2: the head conv, (N, 16, 480, 854) -> 1, with bias, at N=1, 8,
    # 16, YouTube-VOS's (2, 16, 720, 1280) and, in bfloat16 only, N=64 (the
    # sharded phase's group of four); in bfloat16 within one ulp at
    # the output's peak (a float32 sum that differs in its last bits can round
    # to the neighbouring value), with 99.99 % of values equal
    w = (torch.rand(1, 16, 3, 3, generator=g) * 0.2 - 0.1).cuda()
    b = (torch.rand(1, generator=g) * 0.2 - 0.1).cuda()
    wh, bh = w.to(torch.bfloat16), b.to(torch.bfloat16)
    convs, convs16 = [], []
    for shape in [(1, 16, 480, 854), (8, 16, 480, 854), (16, 16, 480, 854),
                  (2, 16, 720, 1280), (64, 16, 480, 854)]:
        n, _, h, wd = shape
        if n == 64:     # the multi-sequence engine's window, bfloat16 only
            xh = torch.relu(torch.randn(shape, generator=gc, device="cuda")).to(torch.bfloat16)
        else:
            x = torch.relu(torch.randn(shape, generator=g)).cuda()
            convs.append(_compare(
                "conv3x3_cout1", list(shape), lambda x=x: conv3x3_cout1(x, w, b),
                lambda x=x: conv3x3_cout1_plain(x, w, b),
                lambda x=x: F.conv2d(x, w, b, padding=1),
                nbytes=4 * (x.numel() + n * h * wd + w.numel() + 1),
                flops=2 * 9 * x.numel(), tol=5e-5))
            xh = x.to(torch.bfloat16)
            del x
        row = _compare(
            "conv3x3_cout1_bf16", list(shape), lambda x=xh: conv3x3_cout1(x, wh, bh),
            lambda x=xh: conv3x3_cout1_plain(x, wh, bh),
            lambda x=xh: F.conv2d(x, wh, bh, padding=1),
            nbytes=2 * (xh.numel() + n * h * wd + w.numel() + 1),
            flops=2 * 9 * xh.numel(), tol="bf16_ulp")
        row["values_equal_share"] = float(
            (conv3x3_cout1(xh, wh, bh) == conv3x3_cout1_plain(xh, wh, bh)).float().mean())
        if row["values_equal_share"] < 0.9999:
            fail(f"conv3x3_cout1_bf16 {list(shape)}: {row['values_equal_share']} of values "
                 "equal to the plain version's, under 99.99 %")
        convs16.append(row)
        del xh
    rows["conv3x3_cout1"] = convs
    rows["conv3x3_cout1_bf16"] = convs16
    # each bfloat16 row beside the float32 row of the same shape and values
    for name in ("pyrup", "conv3x3_cout1"):
        for r16, r32 in zip(rows[f"{name}_bf16"], rows[name]):
            r16["bf16_over_f32"] = r16["ms"] / r32["ms"]

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
        n_read = src.shape[0] * warp_source_pixels([M], src.shape[1:], size, mode)
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
    # the mixed paste first: the form the host augmenter launches on the main
    # path (its label no longer takes a launch of its own, the "label" row)
    forms = warp_form_rows(g, rgba, lbl, Ts, Tw, launch_floor_ms)
    rows["warp_affine"] = forms[:2] + warps + [perspective_row(img, launch_floor_ms)]
    rows["remap"] = remap_checks(img)
    rows["warp_affine_batched"] = forms[2:]
    rows.update(backward_rows(g))
    emit({"phase": "kernels", "launch_floor_ms": launch_floor_ms, "rows": rows})
    return rows


def perspective_row(img, launch_floor_ms):
    """warp_perspective on the card (kernel 3's direct variant, which takes
    projective maps) against its plain version, bit-exact, on a full frame
    (bicubic) by a projective matrix; with its byte bound and F.grid_sample's
    time for the same work."""
    import torch.nn.functional as F
    from frtm_tpu_torch.ops.kernels import VARIANTS
    from frtm_tpu_torch.ops.warp import inverse_coefficients, warp_affine_plain, warp_perspective
    P = np.array([[1.05, 0.04, -20.0], [-0.03, 0.97, 12.0], [6e-5, -4e-5, 1.0]])
    size = (480, 854)
    n_read = img.shape[0] * warp_source_pixels([P], img.shape[1:], size, "bicubic")
    n_out = img.shape[0] * size[0] * size[1]
    grid = inverse_grid(P, size, img.shape[1:])
    row = _compare(
        "warp_perspective", [*img.shape, "bicubic", list(size)],
        lambda: warp_perspective(img, P, size, "bicubic"),
        lambda: warp_affine_plain(img, inverse_coefficients(P), size, "bicubic"),
        lambda: F.grid_sample(img[None], grid, mode="bicubic", padding_mode="zeros",
                              align_corners=True),
        nbytes=4 * (n_read + n_out), flops=n_out * (2 * 16 + 20), tol=0.0)
    before = dict(VARIANTS["warp_affine"])
    warp_perspective(img, P, size, "bicubic")
    row["variant"] = [v for v, n in VARIANTS["warp_affine"].items() if n > before[v]][0]
    row.update(role="perspective", source_values_read=n_read, launch_floor_ms=launch_floor_ms)
    if row["variant"] != "direct":
        fail(f"kernels: warp_perspective took the {row['variant']} variant, not direct")
    return row


def remap_checks(img):
    """remap (plain torch on both devices, as frtm_tpu's is XLA) on the card
    against the same call on the CPU, bit-exact, in each mode, on a full
    frame under a smooth distortion reaching past the edges; with the
    card's time."""
    from frtm_tpu_torch.ops.warp import remap
    yy, xx = np.mgrid[0:480, 0:854].astype(np.float32)
    map_x = xx * 1.02 - 8.0 + 6.0 * np.sin(yy / 40.0)
    map_y = yy * 0.98 + 5.0 + 4.0 * np.cos(xx / 55.0)
    mx, my = torch.from_numpy(map_x).cuda(), torch.from_numpy(map_y).cuda()
    out = []
    for mode in ("nearest", "bilinear", "bicubic"):
        got = remap(img, mx, my, mode).cpu()
        want = remap(img.cpu(), map_x, map_y, mode)
        err = float((got - want).abs().max())
        if err != 0.0:
            fail(f"kernels: remap ({mode}) on the card differs from the CPU by {err}")
        out.append({"mode": mode, "shape": [*img.shape, 480, 854], "max_abs_err": err,
                    "tolerance": 0.0, "ms": cuda_ms(lambda mode=mode: remap(img, mx, my, mode))[0]})
    return out


def device_round_inputs(aug_params, size=(480, 854), seed=3):
    """The inputs of the device augmenter's first retry round on a textured
    frame with a 120 px square target: (inpainted, target crop, mask, fg_T,
    fg_T_full, fg_K, bg_T, bg_K, out_hw) as batch_augment takes them."""
    from frtm_tpu_torch.models import device_augmenter as tda
    frame = textured_frame(size, seed)
    mask = np.zeros(size + (1,), np.float32)
    mask[180:300, 367:487] = 1
    captured, inner = [], tda.batch_augment

    def spy(*args):
        captured.append(args)
        return inner(*args)
    tda.batch_augment = spy
    try:
        tda.DeviceAugmenter(aug_params, "cuda").augment_first_frame(frame, mask,
                                                                    np.random.RandomState(0))
    finally:
        tda.batch_augment = inner
    return captured[0]


def warp_form_rows(g, rgba, lbl, Ts, Tw, launch_floor_ms):
    """Kernel 3's mixed and batched launches against their plain versions
    (bit-exact), each with its time, byte bound and F.grid_sample's time for
    the same work: the host augmenter's paste (the RGBA target and its
    label in one launch, the 200x240 box of the single-map rows; and the
    worst footprint there), then one round of the device augmenter at S = 19
    (the background, the target crop and the mask, each under its round's
    maps)."""
    import torch.nn.functional as F
    from frtm_tpu_torch.config import eval_aug_params
    from frtm_tpu_torch.ops.kernels import VARIANTS, warp_affine, warp_affine_batched
    from frtm_tpu_torch.ops.warp import inverse_coefficients, warp_affine_batched_plain

    both = torch.cat([rgba, lbl])
    inp, crop, mask, fg_T, fg_Tf, _, bg_T, _, _ = device_round_inputs(eval_aug_params(5))
    forms = [("paste_mixed", both, [Ts], (200, 240), "bicubic", 4, False),
             ("paste_mixed_worst", both, [Tw], (200, 240), "bicubic", 4, False),
             ("background_round", inp.float(), bg_T, (480, 854), "bicubic", None, True),
             ("target_round", crop.float(), fg_T, (480, 854), "bicubic", None, True),
             ("label_round", mask.float(), fg_Tf, (480, 854), "nearest", None, True)]
    rows = []
    for role, src, Ms, size, mode, nearest_from, batched in forms:
        c = src.shape[0]
        k = c if nearest_from is None else nearest_from
        hinvs = np.stack([inverse_coefficients(M) for M in Ms])
        # the source is read once for all maps: the union of their taps
        n_read = (k * warp_source_pixels(Ms, src.shape[1:], size, mode)
                  + (c - k) * warp_source_pixels(Ms, src.shape[1:], size, "nearest"))
        n_out = len(Ms) * c * size[0] * size[1]
        taps = {"nearest": 1, "bilinear": 4, "bicubic": 16}[mode]
        flops = len(Ms) * size[0] * size[1] * (k * (2 * taps + 20) + (c - k) * 20)
        grid = torch.cat([inverse_grid(M, size, src.shape[1:]) for M in Ms])

        def lib(src=src, grid=grid, mode=mode, k=k):
            # one grid_sample per mode over the S maps (nearest rounds halves
            # to even where the kernel takes floor(x + 0.5))
            s = src[None].expand(grid.shape[0], *src.shape)
            out = F.grid_sample(s[:, :k], grid, mode=mode, padding_mode="zeros",
                                align_corners=True)
            if k < s.shape[1]:
                out = F.grid_sample(s[:, k:], grid, mode="nearest", padding_mode="zeros",
                                    align_corners=True)
            return out

        if batched:
            kernel = (lambda src=src, Ms=Ms, size=size, mode=mode, nf=nearest_from:
                      warp_affine_batched(src, Ms, size, mode, nf))
        else:
            kernel = (lambda src=src, M=Ms[0], size=size, mode=mode, nf=nearest_from:
                      warp_affine(src, M, size, mode, nf)[None])
        row = _compare(
            "warp_affine", [c, *src.shape[1:], mode, list(size), len(Ms)], kernel,
            lambda src=src, h=hinvs, size=size, mode=mode, nf=nearest_from:
                warp_affine_batched_plain(src, h, size, mode, nf),
            lib, nbytes=4 * (n_read + n_out), flops=flops, tol=0.0)
        before = dict(VARIANTS["warp_affine"])
        kernel()
        row["variant"] = [v for v, n in VARIANTS["warp_affine"].items() if n > before[v]][0]
        row.update(role=role, maps=len(Ms), nearest_from=nearest_from,
                   source_values_read=n_read, launch_floor_ms=launch_floor_ms,
                   library="F.grid_sample, one call per mode over the maps")
        want = "staged_batched" if batched else "staged"
        if row["variant"] != want:
            fail(f"kernels: the {role} warp took the {row['variant']} variant, not {want}")
        rows.append(row)
    return rows


def backward_rows(g):
    """The backward kernels at the training shapes, each against its plain
    backward (autograd of the plain forward on the card): N = 16, the
    batch of one card, then N = 8, a rank's rows of the dp_train phase's
    global batch of 16 split over two."""
    from frtm_tpu_torch.ops.kernels import (VARIANTS, pyr_up_bicubic_backward,
                                            pyr_up_bicubic_backward_plain)
    rows = {"pyrup_bwd": [], "conv3x3_cout1_dx": [], "conv3x3_cout1_dw": []}
    for shape in [(16, 32, 120, 214), (16, 16, 240, 428), (8, 32, 120, 214), (8, 16, 240, 428)]:
        n, c, h, w = shape
        gy = torch.randn(n, c, 2 * h, 2 * w, generator=g).cuda()
        before = dict(VARIANTS["pyrup_bwd"])
        row = _compare(
            "pyrup_bwd", list(shape), lambda gy=gy, s=shape: pyr_up_bicubic_backward(gy, s),
            lambda gy=gy, s=shape: pyr_up_bicubic_backward_plain(gy, s),
            lambda gy=gy, s=shape: torch.ops.aten.upsample_bicubic2d_backward(
                gy, [2 * s[2], 2 * s[3]], list(s), False),
            nbytes=4 * (gy.numel() + gy.numel() // 4), flops=35 * gy.numel(),
            tol=("peak", 1e-5))
        row["variant"] = sorted(v for v, k in VARIANTS["pyrup_bwd"].items() if k > before[v])
        if row["variant"] != ["v4"]:
            fail(f"pyrup_bwd {shape}: took {row['variant']}, not the 16-byte loads (v4)")
        rows["pyrup_bwd"].append(row)
        del gy
    wt = (torch.rand(1, 16, 3, 3, generator=g) * 0.2 - 0.1).cuda()
    for shape in [(16, 16, 480, 854), (8, 16, 480, 854)]:
        conv_backward_rows(rows, g, shape, wt)
    return rows


def conv_backward_rows(rows, g, shape, wt):
    """The head conv's dx and its dw and db at `shape`, appended to rows."""
    from frtm_tpu_torch.ops.kernels import (
        VARIANTS, conv3x3_cout1_input_grad, conv3x3_cout1_input_grad_plain,
        conv3x3_cout1_weight_grad, conv3x3_cout1_weight_grad_plain)
    from frtm_tpu_torch.ops.kernels.conv3x3_cout1 import input_grad_plan, weight_grad_plan
    x = torch.relu(torch.randn(shape, generator=g)).cuda()
    gy = (torch.randn(shape[0], 1, *shape[2:], generator=g) * 1e-3).cuda()
    before = dict(VARIANTS["conv3x3_cout1_dx"])
    row = _compare(
        "conv3x3_cout1_dx", list(shape), lambda: conv3x3_cout1_input_grad(gy, wt, shape),
        lambda: conv3x3_cout1_input_grad_plain(gy, wt, shape),
        lambda: torch.nn.grad.conv2d_input(shape, wt, gy, padding=1),
        nbytes=4 * (gy.numel() + x.numel() + wt.numel()), flops=18 * x.numel(),
        tol=("peak", 1e-5))
    row["variant"] = sorted(v for v, k in VARIANTS["conv3x3_cout1_dx"].items() if k > before[v])
    if row["variant"] != ["v2"]:
        fail(f"conv3x3_cout1_dx {shape}: took {row['variant']}, not the 8-byte stores (v2)")
    row["rows"] = input_grad_plan(*shape)
    row["warps"] = input_grad_plan(*shape, "warps")
    rows["conv3x3_cout1_dx"].append(row)
    before = dict(VARIANTS["conv3x3_cout1_dw"])
    row = _compare(
        "conv3x3_cout1_dw", list(shape),
        lambda: torch.cat([t.flatten() for t in conv3x3_cout1_weight_grad(x, gy)]),
        lambda: torch.cat([t.flatten() for t in conv3x3_cout1_weight_grad_plain(x, gy, wt.shape)]),
        lambda: torch.cat([torch.nn.grad.conv2d_weight(x, wt.shape, gy, padding=1).flatten(),
                           gy.sum().reshape(1)]),
        nbytes=4 * (x.numel() + gy.numel() + wt.numel() + 1),
        flops=18 * x.numel() + gy.numel(), tol=("peak", 1e-4))
    row["variant"] = sorted(v for v, k in VARIANTS["conv3x3_cout1_dw"].items() if k > before[v])
    if row["variant"] != ["v2"]:
        fail(f"conv3x3_cout1_dw {shape}: took {row['variant']}, not the 8-byte loads (v2)")
    row["rows"] = weight_grad_plan(*shape, x.device)
    rows["conv3x3_cout1_dw"].append(row)


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
    returns a function that decodes frame 1's logits with the refiner, in
    float32 or, given torch.bfloat16, as the fused tracker decodes in that
    type: a bfloat16 copy of the refiner, features and scores cast at its
    door."""
    from frtm_tpu_torch.ops.conv import compute_copy
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

    def decode(dtype=torch.float32):
        return seg_network_apply(compute_copy(tracker.refiner, dtype), scores.to(dtype),
                                 {L: f.to(dtype) for L, f in refnet_feats.items()}, size,
                                 layers=cfg.refnet_layers)
    return decode


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
    scale_head, from the same logits; then the decode in bfloat16."""
    from frtm_tpu_torch.ops.kernels import VARIANTS, reset_launches
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
    after = decode()

    # the same decode as the fused tracker runs it in bfloat16 (scaled head):
    # kernels against plain versions, counted per instance. Kernel 1 is
    # exact, so only the head conv's last rounding can differ: one ulp at the
    # logits' peak. The gap to float32 is reported, not limited.
    reset_launches()
    got16 = decode(torch.bfloat16)
    instances = {k: dict(VARIANTS[k]) for k in ("pyrup", "conv3x3_cout1")}
    with plain_decoder():
        want16 = decode(torch.bfloat16)
    torch.cuda.synchronize()
    if got16.dtype != torch.bfloat16 or not bool(torch.isfinite(got16.float()).all()):
        fail(f"decode: bfloat16 logits are {got16.dtype}, or not finite")
    if instances != {"pyrup": {"f32": 0, "bf16": 2}, "conv3x3_cout1": {"f32": 0, "bf16": 1}}:
        fail(f"decode: a bfloat16 decode must launch only bfloat16 instances, got {instances}")
    err16 = float((got16.float() - want16.float()).abs().max())
    tol16 = bf16_ulp(float(want16.float().abs().max()))
    if err16 > tol16:
        fail(f"decode: bfloat16 kernels vs plain logits differ by {err16} (tolerance {tol16})")
    gap = (got16.float() - after).abs()
    emit({"phase": "decode", "logits_shape": list(got.shape), "max_abs_err": err,
          "logit_scale": scale, "tolerance": tol, "head_median": median, "head_std": std,
          "logits_before": logit_stats(got), "logits_after": logit_stats(after),
          "bf16": {"max_abs_err": err16, "tolerance": tol16, "instances": instances,
                   "values_equal_share": float((got16 == want16).float().mean()),
                   "logit_peak": float(after.abs().max()),
                   "gap_to_float32_max": float(gap.max()),
                   "gap_to_float32_rms": float(gap.square().mean().sqrt()),
                   "sign_flips_share": float(((got16.float() > 0) != (after > 0)).float().mean())}})


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
    tracker.timer.reset()
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
          "resolves": int(target.state.n_resolves),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "finite": finite, "shapes_ok": shapes_ok,
          "fg_pixels": fg, "gt_pixels": gt, "intersection": inter})
    if not (finite and shapes_ok and len(outputs) == len(seq)):
        fail("main: outputs are not finite uint8 label images of the frame size")
    if one_class:
        fail(f"main: tracked frames {one_class} are labelled all one class")
    missing = [k for k in FORWARD_KERNELS if launches[k] == 0]
    if missing:
        fail(f"main: kernels never launched on the main path: {missing}")
    if any(launches[k] for k in BACKWARD_KERNELS):
        fail(f"main: tracking launched a backward kernel: {launches}")
    if warp_variants["direct"] or warp_variants["staged"] != launches["warp_affine"]:
        fail(f"main: every warp must take the staged kernel, got {warp_variants}")
    if launches["pyrup"] != 2 * tracked or launches["conv3x3_cout1"] != tracked:
        fail(f"main: expected 2 pyrup and 1 head-conv launch per tracked frame, got {launches}")
    if int(target.state.n_resolves) != (len(seq) - 1) // cfg.disc.train_skipping:
        fail(f"main: {int(target.state.n_resolves)} filter re-solves, expected one every "
             f"{cfg.disc.train_skipping} frames")
    return launches


def trace_device_seconds(fn):
    """Runs fn under torch.profiler's CUDA activity; returns (fn's result,
    seconds of device time summed over everything the trace holds: kernels,
    copies, memsets)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            total_us += getattr(ev, "device_time", None) or getattr(ev, "cuda_time", 0.0)
    return out, total_us / 1e6


def phase_fused(cfg, backbone, refiner):
    """The fused tracker's float32 path: two objects, 17 frames (two windows
    of 8, two re-solves per object), against the host loop and against its
    own compact-augment run."""
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.ops.kernels import LAUNCHES, VARIANTS, reset_launches
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    from frtm_tpu_torch.runtime.tracker import Tracker

    n_objects, n_frames = 2, 17
    seq = make_moving_square_sequence(n_frames=n_frames, size=(480, 854), square=120,
                                      n_objects=n_objects, seed=0)
    tracked = n_frames - 1
    windows = -(-tracked // cfg.disc.train_skipping)
    fused = BatchedSequenceTracker(cfg, backbone, refiner, device="cuda")
    # warm-up on a short sequence (first launches at the window's batch)
    fused.run_sequence(make_moving_square_sequence(n_frames=9, size=(480, 854), square=120,
                                                   n_objects=n_objects, seed=5))
    torch.cuda.synchronize()

    def counted(run):
        reset_launches()
        out = run()
        torch.cuda.synchronize()
        return out, dict(LAUNCHES), dict(VARIANTS["warp_affine"])

    # the timed pass: no synchronisation inside, no profiler
    torch.cuda.reset_peak_memory_stats()
    (out_fused, fps_fused), launches, variants = counted(lambda: fused.run_sequence(seq))
    peak = torch.cuda.max_memory_allocated()
    enqueue_seconds = {k: v["total_s"] for k, v in fused.last_phase_stats.items()}
    params, state = fused.last_models              # one lane per object
    resolves = state.n_resolves.tolist()
    finite = bool(torch.isfinite(params.filter).all())

    # the same pass under the profiler: device time of all it ran over its wall
    (out_traced, fps_traced), device_s = trace_device_seconds(lambda: fused.run_sequence(seq))
    traced_wall = n_frames / fps_traced
    # and once more with a synchronise at every phase edge, counting host waits
    fused.profile = True
    _, fps_profiled = fused.run_sequence(seq)
    fused.profile = False
    stats = fused.last_phase_stats
    phase_seconds = {k: v["total_s"] for k, v in stats.items()}
    host_cpu_seconds = {k: v["cpu_ms_per_call"] * v["count"] / 1e3 for k, v in stats.items()}
    host_syncs = stats["scan"]["host_syncs"]
    host_syncs_at = stats["scan"]["host_syncs_at"]

    host = Tracker(cfg, backbone, refiner, device="cuda")
    (out_host, fps_host), launches_host, variants_host = counted(lambda: host.run_sequence(seq))
    # and the host loop's phase seconds, from a pass of its own
    host_profiled = Tracker(cfg, backbone, refiner, device="cuda", profile=True)
    _, fps_host_profiled = host_profiled.run_sequence(seq)
    compact = BatchedSequenceTracker(cfg, backbone, refiner, device="cuda", aug_compact=True)
    (out_compact, fps_compact), launches_compact, variants_compact = counted(
        lambda: compact.run_sequence(seq))

    def diffs(a, b):
        return [float(np.mean(x != y)) for x, y in zip(a, b)]

    d_host, d_compact, d_traced = (diffs(out_fused, o) for o in (out_host, out_compact, out_traced))
    pixels = {i: [int((o == i).sum()) for o in out_fused] for i in range(1, n_objects + 1)}
    emit({"phase": "fused", "arch": cfg.feature_extractor, "frames": n_frames,
          "objects": n_objects, "size": [480, 854], "windows": windows,
          "fps_fused": fps_fused, "fps_host_loop": fps_host, "fps_fused_compact": fps_compact,
          "fps_fused_traced": fps_traced, "fps_fused_profiled": fps_profiled,
          "fps_host_loop_profiled": fps_host_profiled,
          "phase_seconds": phase_seconds, "enqueue_seconds_timed_pass": enqueue_seconds,
          "phase_seconds_host_loop": dict(host_profiled.phase_seconds),
          "host_cpu_seconds": host_cpu_seconds,
          "scan_host_syncs": host_syncs, "scan_host_syncs_per_window": host_syncs / windows,
          "scan_host_syncs_at": host_syncs_at,
          "max_memory_allocated": peak,
          "device_busy_share": device_s / traced_wall, "device_seconds": device_s,
          "traced_wall_s": traced_wall,
          "launches": launches, "warp_variants": variants, "launches_host_loop": launches_host,
          "launches_compact": launches_compact, "resolves": resolves, "finite": finite,
          "label_mismatch_vs_host_loop_max": max(d_host),
          "label_mismatch_vs_compact_max": max(d_compact),
          "label_mismatch_vs_traced_rerun_max": max(d_traced),
          "label_mismatch_vs_host_loop": d_host,
          "object_pixels_min": {i: min(v[1:]) for i, v in pixels.items()},
          "tolerance": {"labels": 5e-3}})
    if not finite or len(out_fused) != n_frames or any(
            o.shape != (480, 854) or o.dtype != np.uint8 for o in out_fused):
        fail("fused: outputs are not finite uint8 label images of the frame size")
    if max(d_host) >= 5e-3:
        fail(f"fused: labels differ from the host loop's on {max(d_host):.4%} of a frame")
    if max(d_compact) >= 5e-3:
        fail(f"fused: compact-augment labels differ from dense on {max(d_compact):.4%}")
    if max(d_traced) >= 5e-3:
        fail(f"fused: two runs of the same tracker differ on {max(d_traced):.4%} of a frame")
    lost = [i for i, v in pixels.items() if min(v[1:]) == 0]
    if lost:
        fail(f"fused: objects {lost} are missing from a tracked frame")
    for name, ln, vr in (("dense", launches, variants), ("compact", launches_compact,
                                                         variants_compact)):
        if ln["pyrup"] != 2 * windows or ln["conv3x3_cout1"] != windows:
            fail(f"fused ({name}): expected 2 pyrup and 1 head-conv launch per decode call "
                 f"({windows} windows), got {ln}")
        # per object 4 accepted specs, each one mixed launch (RGBA + label)
        if vr["direct"] or vr["staged"] != ln["warp_affine"] or ln["warp_affine"] != 4 * n_objects:
            fail(f"fused ({name}): expected 4 staged warps per object and no other, "
                 f"got {ln['warp_affine']} launches, {vr}")
    if resolves != [tracked // cfg.disc.train_skipping] * n_objects:
        fail(f"fused: filter re-solves {resolves}, expected one per window and object")
    return launches


def is_kernel(ev):
    """A kernel in a torch.profiler trace (not a copy or a memset)."""
    return str(getattr(ev, "device_type", "")).endswith("CUDA") and \
        not ev.name.startswith(("Memcpy", "Memset"))


@contextlib.contextmanager
def per_phase_readings(names):
    """While the block runs, every PhaseTimer phase of the given names runs
    in a torch.profiler session of its own, with the card synchronised at
    both edges: yields {name: {"kernels": device kernels the phase ran,
    "by_name": those kernels counted by name, "peak_bytes": the most memory
    allocated inside it}}, summed (kernels) or maximised (peak) over the
    phase's calls."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    from frtm_tpu_torch.utils.profiling import PhaseTimer
    readings = {n: {"kernels": 0, "by_name": Counter(), "peak_bytes": 0} for n in names}
    plain = PhaseTimer.phase

    @contextlib.contextmanager
    def phase(self, name):
        if name not in readings:
            with plain(self, name):
                yield
            return
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with plain(self, name):
                yield
            torch.cuda.synchronize()
        kernels = [ev.name for ev in prof.events() if is_kernel(ev)]
        readings[name]["kernels"] += len(kernels)
        readings[name]["by_name"].update(kernels)
        readings[name]["peak_bytes"] = max(readings[name]["peak_bytes"],
                                           torch.cuda.max_memory_allocated())

    PhaseTimer.phase = phase
    try:
        yield readings
    finally:
        PhaseTimer.phase = plain


def init_scaling_readings(cfg, backbone, refiner, counts=(1, 2, 4), n_frames=9):
    """The fused tracker (float32, 480x854) on a sequence of n_frames with
    each number of objects in `counts`, all from frame 0: after a warm-up
    pass, the disc_init and scan seconds of a pass synchronised at every
    phase edge (profile=True), then, in another such pass, the kernels each
    of the two phases ran and the peak memory inside it. 9 frames are one
    window of 8: one re-solve per object. Returns {n: readings}."""
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    out = {}
    for n in counts:
        seq = make_moving_square_sequence(n_frames=n_frames, size=(480, 854), square=120,
                                          n_objects=n, seed=0)
        fused = BatchedSequenceTracker(cfg, backbone, refiner, device="cuda", profile=True)
        fused.run_sequence(seq)                        # warm-up
        _, fps = fused.run_sequence(seq)
        stats = fused.last_phase_stats
        with per_phase_readings(("disc_init", "scan")) as readings:
            fused.run_sequence(seq)
        out[n] = {"disc_init_s": stats["disc_init"]["total_s"], "scan_s": stats["scan"]["total_s"],
                  "fps_profiled": fps,
                  "kernels": {k: v["kernels"] for k, v in readings.items()},
                  "kernels_by_name": {k: dict(v["by_name"]) for k, v in readings.items()},
                  "peak_bytes": {k: v["peak_bytes"] for k, v in readings.items()}}
        del fused
        torch.cuda.empty_cache()
    return out


def phase_init_scaling(cfg, backbone, refiner, card):
    """The target models of 1, 2 and 4 objects solved together: the kernels
    that disc_init and the scan run must not grow with the number of
    objects (at most 1.25x those at one object; a loop over objects gives
    about 4x at four)."""
    readings = init_scaling_readings(cfg, backbone, refiner)
    ratios = {k: readings[4]["kernels"][k] / readings[1]["kernels"][k]
              for k in ("disc_init", "scan")}
    # the kernels whose count differs between one and four objects, by name
    grew = {k: {name: [readings[1]["kernels_by_name"][k].get(name, 0), n4]
                for name, n4 in readings[4]["kernels_by_name"][k].items()
                if n4 != readings[1]["kernels_by_name"][k].get(name, 0)}
            for k in ("disc_init", "scan")}
    for r in readings.values():
        del r["kernels_by_name"]
    emit({"phase": "init_scaling", "arch": cfg.feature_extractor, "size": [480, 854],
          "frames": 9, "card": card, "objects": readings,
          "kernels_4_over_1": ratios, "limit": 1.25, "kernels_1_and_4_where_they_differ": grew})
    grown = {k: v for k, v in ratios.items() if v > 1.25}
    if grown:
        fail(f"init_scaling: kernels at four objects over one grew by {grown}")



# the sharded phase's synthetic sequences: seeds, and 480x854 with two squares
SHARDED_SEEDS = (0, 1, 2, 3)


def sharded_sequences(n_frames):
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    return [make_moving_square_sequence(n_frames=n_frames, size=(480, 854), square=120,
                                        n_objects=2, seed=s, name=f"seq{s}")
            for s in SHARDED_SEEDS]


def sharded_argv(workdir):
    """The CLI's arguments for the sharded engine on the .pth files that
    phase_sharded writes into `workdir`."""
    return ["--model", str(workdir / "rn101_smoke.pth"), "--backbone",
            str(workdir / "resnet101.pth"), "--dset", "dv2017val", "--dev", "cuda",
            "--dtype", "bfloat16", "--engine", "sharded"]


def sharded_child(workdir):
    """One rank of the sharded phase's two processes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT in the environment): the CLI with
    --multihost on the phase's 4-sequence x 9-frame dataset."""
    import os
    sys.path.insert(0, str(ROOT))
    from frtm_tpu_torch import evaluate
    workdir = Path(workdir)
    dataset = SyntheticDataset("synthval", sharded_sequences(9),
                               workdir / f"annotations{os.environ['RANK']}")
    evaluate.main(sharded_argv(workdir) + ["--output", str(workdir / "two"), "--multihost"],
                  dataset=dataset)


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def two_process_run(backbone, refiner):
    """The CLI's --engine sharded on a 4-sequence x 9-frame dataset, in this
    process and in two processes on this card that join a gloo group
    through the environment: the PNGs must be equal byte for byte, each
    process must track its round-robin share and only rank 0 score."""
    import os
    from frtm_tpu_torch import evaluate
    with tempfile.TemporaryDirectory(prefix="frtm_sharded_") as tmp:
        tmp = Path(tmp)
        torch.save({"model": {"refiner." + k: v.detach().cpu()
                              for k, v in refiner.state_dict().items()}, "epoch": 260},
                   tmp / "rn101_smoke.pth")
        torch.save({k: v.detach().cpu() for k, v in backbone.state_dict().items()},
                   tmp / "resnet101.pth")
        seqs = sharded_sequences(9)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            one = evaluate.main(sharded_argv(tmp) + ["--output", str(tmp / "one")],
                                dataset=SyntheticDataset("synthval", seqs, tmp / "annotations"))
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                   WORLD_SIZE="2", LOCAL_RANK="0")
        t0 = time.perf_counter()
        children = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                      "--sharded-child", str(tmp)],
                                     env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                    for rank in range(2)]
        try:
            outs = [child.communicate(timeout=600)[0] for child in children]
        finally:
            for child in children:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        wall = time.perf_counter() - t0
        for rank, (child, out) in enumerate(zip(children, outs)):
            if child.returncode != 0:
                fail(f"sharded: rank {rank} of two exited with {child.returncode}:\n{out[-3000:]}")
        two = tmp / "two" / one["out_path"].name
        differ = [f"{s.name}/{f}" for s in seqs for f in s.frame_names
                  if (two / s.name / f"{f}.png").read_bytes()
                  != (one["out_path"] / s.name / f"{f}.png").read_bytes()]
        shares = [f"multihost: process {r}/2 tracking 2/4 sequences" in outs[r] for r in range(2)]
        scored = ["Computing J-scores" in out for out in outs]
        reports = [(two / f"evaluation-{m}.txt").read_text()
                   == (one["out_path"] / f"evaluation-{m}.txt").read_text() for m in "JF"]
        written = [sorted(line.split(":")[0] for line in out.splitlines()
                          if line.endswith("frames written")) for out in outs]
    result = {"pngs_differ": differ, "shares_as_round_robin": shares, "scored_by_rank": scored,
              "reports_equal": reports, "written_by_rank": written, "wall_s": wall,
              "one_process_fps": one["fps"]}
    if differ or not all(shares) or scored != [True, False] or not all(reports) \
            or written != [["seq0", "seq2"], ["seq1", "seq3"]]:
        fail(f"sharded: two processes against one: {result}")
    return result


def phase_sharded(cfg, backbone, refiner, card):
    """The multi-sequence engine (parallel/multi_sequence.py) at full width
    in bfloat16: groups of 1, 2 and 4 sequences of 17 frames with two
    objects against the fused tracker on each sequence alone; the kernels of
    a group's scan at 4 sequences at most 1.25x those at 1, kernels 1 and 2
    launched as often for a group as for one sequence, all bf16; aggregate
    fps, synchronised phase seconds and peak memory; then the CLI's
    --multihost in two processes. Returns the port's kernel launches of the
    4-sequence group's run_sequences (the main path).

    The labels' bound: at B = 1 the group runs the fused tracker's shapes,
    and its labels must lie within 0.5 % a frame of the fused tracker's. At
    B = 2 and 4 cuBLAS and cuDNN pick other kernels for the wider batches
    (the init's solve of 2B lanes, the decode of 16B), whose last bits
    differ, and these random weights' target models carry such a difference
    into the labels as far as any other of their size: the bound is twice
    the fused tracker's own label movement when its init filters move by
    one part in 1e6 (the yardstick, measured here on every sequence), plus
    0.5 % (scripts/torch_sharded_agreement.py takes the gap apart). Whether
    every gap also lies under 0.5 % is printed."""
    from dataclasses import replace
    from frtm_tpu_torch.ops.kernels import LAUNCHES, VARIANTS, reset_launches
    from frtm_tpu_torch.parallel import ShardedSequenceTracker, make_mesh
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    from frtm_tpu_torch.utils.profiling import PhaseTimer

    bf16 = replace(cfg, compute_dtype="bfloat16")
    n_frames, n_objects = 17, 2
    windows = -(-(n_frames - 1) // cfg.disc.train_skipping)
    seqs = sharded_sequences(n_frames)
    fused = BatchedSequenceTracker(bf16, backbone, refiner, extract_chunk=16, device="cuda")
    fused.run_sequence(seqs[0])                     # warm-up
    alone = {s.name: fused.run_sequence(s)[0] for s in seqs}
    init = fused._init_objects_dense

    def nudged(images, labels):
        params, state = init(images, labels)
        return params._replace(filter=params.filter * (1 + 1e-6)), state

    fused._init_objects_dense = nudged
    yardstick = [max(float(np.mean(a != b)) for a, b in zip(fused.run_sequence(s)[0],
                                                             alone[s.name])) for s in seqs]
    del fused._init_objects_dense
    limit = 2 * max(yardstick) + 5e-3
    group = ShardedSequenceTracker(bf16, backbone, refiner, make_mesh(device="cuda"), extract_chunk=16,
                                   device="cuda")
    readings, launches_main = {}, None
    for B in (1, 2, 4):
        members = seqs[:B]
        group.run_sequences(members)                # warm-up at this width
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out = group.run_sequences(members)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = dict(LAUNCHES)
        instances = {k: dict(VARIANTS[k]) for k in ("pyrup", "conv3x3_cout1", "warp_affine")}
        gaps = [max(float(np.mean(a != b)) for a, b in zip(out[s.name], alone[s.name]))
                for s in members]
        pixels = [min(int((lb == i).sum()) for lb in out[s.name][1:])
                  for s in members for i in range(1, n_objects + 1)]
        key = group._group_key_meta(members[0])
        preps = [(s, group._prepare(s)) for s in members]
        timer = PhaseTimer(sync=True, device="cuda")
        group._run_group(preps, key, timer=timer)
        with per_phase_readings(("group_scan",)) as scan:
            group._run_group(preps, key)
        del preps
        fps = []
        for _ in range(3):
            t0 = time.perf_counter()
            group.run_sequences(members)
            fps.append(B * n_frames / (time.perf_counter() - t0))
        readings[B] = {"fps_aggregate": fps, "label_gap_vs_fused_alone": gaps,
                       "phase_seconds": {k: v["total_s"] for k, v in timer.stats().items()},
                       "kernels": {k: v["kernels"] for k, v in scan.items()},
                       "peak_bytes_group": {k: v["peak_bytes"] for k, v in scan.items()},
                       "max_memory_allocated": peak, "launches": launches,
                       "instances": instances, "object_pixels_min": min(pixels)}
        if B == 4:
            launches_main = launches
        if max(gaps) >= (5e-3 if B == 1 else limit):
            fail(f"sharded: B = {B}: labels differ from the fused tracker's on "
                 f"{max(gaps):.4%} of a frame (limit {5e-3 if B == 1 else limit:.4%})")
        if min(pixels) == 0:
            fail(f"sharded: B = {B}: an object is missing from a tracked frame")
        if launches["pyrup"] != 2 * windows or launches["conv3x3_cout1"] != windows \
                or instances["pyrup"]["f32"] or instances["conv3x3_cout1"]["f32"] \
                or launches["warp_affine"] != 4 * n_objects * B \
                or instances["warp_affine"]["staged"] != launches["warp_affine"]:
            fail(f"sharded: B = {B}: expected {2 * windows} bf16 pyrup and {windows} bf16 "
                 f"head-conv launches a group (one sequence's) and {4 * n_objects * B} staged "
                 f"warps, got {launches}, {instances}")
    ratio = readings[4]["kernels"]["group_scan"] / readings[1]["kernels"]["group_scan"]
    two = two_process_run(backbone, refiner)
    emit({"phase": "sharded", "arch": cfg.feature_extractor, "dtype": "bfloat16",
          "size": [480, 854], "frames": n_frames, "objects": n_objects, "card": card,
          "groups": readings, "label_gap_vs_fused_alone_max": max(
              max(r["label_gap_vs_fused_alone"]) for r in readings.values()),
          "label_gap_under_0.005": {B: max(r["label_gap_vs_fused_alone"]) < 5e-3
                                    for B, r in readings.items()},
          "yardstick_fused_label_movement_under_1e-6_init_nudge": yardstick,
          "tolerance": {"labels_b1": 5e-3, "labels": limit},
          "scan_kernels_4_over_1": ratio, "limit": 1.25,
          "two_processes": two})
    if ratio > 1.25:
        fail(f"sharded: the group scan's kernels at four sequences are {ratio:.3f}x those at one")
    return launches_main


def augment_call_readings(augmenter, image, mask, sessions=3):
    """One augment_first_frame on the card, made `sessions` times, each in a
    torch.profiler session of its own: the kernels it ran, the port's kernel
    launches by variant, the retry rounds, and the most memory it allocated
    over what was allocated before it.

    torch.profiler loses events. It once lost a whole session's; and late in
    this script (never in a fresh process: 36 sessions read 128 kernels at 4
    and at 19 specs, scripts/torch_augment_round_kernels.py) one round read
    125, 126 or 128 kernels from one session to the next, with equal
    launches (NVIDIA H100). Each session therefore starts with a marker
    kernel (`torch.cuda._sleep`, not counted) and a synchronise before the
    call, and the kernels are the sum over kernel names of the most
    launches of that name a session saw: the card is idle when a session
    starts, so a lost event can only lower a count. `kernels_per_session`
    gives every session's total, `names_below_most` per session the names it
    saw fewer of."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    from frtm_tpu_torch.ops.kernels import LAUNCHES, VARIANTS, reset_launches
    by_session = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1 << 20)
            torch.cuda.synchronize()
            out = augmenter.augment_first_frame(image, mask, np.random.RandomState(0))
            torch.cuda.synchronize()
        by_session.append(Counter(ev.name for ev in prof.events()
                                  if is_kernel(ev) and "spin_kernel" not in ev.name))
    most = Counter()
    for names in by_session:
        most |= names
    return out, {"kernels": sum(most.values()),
                 "kernels_per_session": [sum(c.values()) for c in by_session],
                 "names_below_most": [{k: most[k] - c[k] for k in most if c[k] < most[k]}
                                      for c in by_session],
                 "launches": dict(LAUNCHES), "warp_variants": dict(VARIANTS["warp_affine"]),
                 "rounds": getattr(augmenter, "last_rounds", None),
                 "peak_bytes_over_base": torch.cuda.max_memory_allocated() - base}


def augment_frame():
    """The device_augment phase's first frame: a textured 480x854 frame and
    a 120 px square mask."""
    frame = textured_frame((480, 854), seed=4)
    mask = np.zeros((480, 854, 1), np.float32)
    mask[150:270, 300:420] = 1
    return frame, mask


def augment_round_child():
    """The device_augment phase's launches of one augment round at 4 and at
    19 specs (num_aug in the selections), each after a first call, measured
    in a process of its own (augment_call_readings says why): prints
    {specs: readings} as one JSON line."""
    sys.path.insert(0, str(ROOT))
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.models.device_augmenter import DeviceAugmenter
    resolve_device("cuda")
    aug_params = eval_config("resnet101").aug_params
    frame, mask = augment_frame()
    per_round = {}
    for n in (5, 20):
        p = dict(aug_params, fg_aug_params=dict(aug_params["fg_aug_params"], num_aug=n),
                 bg_aug_params=dict(aug_params["bg_aug_params"], num_aug=n))
        aug = DeviceAugmenter(p, "cuda")
        aug.augment_first_frame(frame, mask, np.random.RandomState(0))   # first launches
        _, per_round[n - 1] = augment_call_readings(aug, frame, mask)
    print(json.dumps(per_round), flush=True)


def augment_round_readings():
    """augment_round_child's readings, from a child process: {4: ..., 19: ...}."""
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--augment-round-child"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           timeout=300)
    if child.returncode != 0:
        fail(f"device_augment: the one-round child exited with {child.returncode}:\n"
             f"{child.stdout[-3000:]}")
    return {int(k): v for k, v in json.loads(child.stdout.strip().splitlines()[-1]).items()}


def augment_backend_readings(cfg, backbone, refiner, n_objects, n_frames=9, passes=3):
    """The fused tracker (480x854, n_objects 120 px squares from frame 0)
    with augment_backend "host" and "device": per backend, after a warm-up
    pass, the fps of `passes` unsynchronised passes (the port's kernel
    launches counted from 0 over them), the augment and disc_init seconds
    of a pass synchronised at every phase edge, the labels, and one
    augment_first_frame of object 1 (augment_call_readings). Returns
    ({backend: readings}, {backend: labels})."""
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.ops.kernels import LAUNCHES, VARIANTS, reset_launches
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    seq = make_moving_square_sequence(n_frames=n_frames, size=(480, 854), square=120,
                                      n_objects=n_objects, seed=0)
    mask = (seq.labels[0][..., 0] == 1).astype(np.float32)[..., None]
    readings, labels = {}, {}
    for backend in ("host", "device"):
        tracker = BatchedSequenceTracker(cfg, backbone, refiner, device="cuda",
                                         augment_backend=backend)
        tracker.run_sequence(seq)                      # warm-up
        torch.cuda.synchronize()
        reset_launches()
        fps = []
        for _ in range(passes):
            labels[backend], f = tracker.run_sequence(seq)
            fps.append(f)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        variants = dict(VARIANTS["warp_affine"])
        tracker.profile = True
        _, fps_profiled = tracker.run_sequence(seq)
        stats = tracker.last_phase_stats
        _, call = augment_call_readings(tracker.augmenter, seq.images[0], mask)
        readings[backend] = {
            "fps": fps, "fps_median": statistics.median(fps), "fps_profiled": fps_profiled,
            "phase_seconds_synchronised": {k: v["total_s"] for k, v in stats.items()},
            "augment_s": stats["augment"]["total_s"], "disc_init_s": stats["disc_init"]["total_s"],
            "launches_per_pass": {k: v / passes for k, v in launches.items()},
            "warp_variants_per_pass": {k: v / passes for k, v in variants.items()},
            "launches_timed_passes": launches, "augment_first_frame": call}
        del tracker
        torch.cuda.empty_cache()
    return readings, labels


def phase_device_augment(cfg, backbone, refiner, card):
    """The device augment backend: DeviceAugmenter on the card against the
    same call on the CPU and against the host augmenter on the card; the
    launches of one round at 4 and at 19 specs; then the fused tracker at
    full width in bfloat16 with both backends. Returns the port's kernel
    launches of the device backend's timed passes (its main path)."""
    from dataclasses import replace
    from frtm_tpu_torch.models import device_augmenter as tda
    from frtm_tpu_torch.models.augmenter import ImageAugmenter

    aug_params = cfg.aug_params
    frame, mask = augment_frame()
    counts, inner = {}, tda.batch_augment

    def spy_on(dev):
        def spy(*args):
            out = inner(*args)
            counts.setdefault(dev, []).append(out[2].cpu().tolist())
            return out
        return spy
    batches = {}
    for dev in ("cuda", "cpu"):
        tda.batch_augment = spy_on(dev)
        try:
            t0 = time.perf_counter()
            batches[dev] = tda.DeviceAugmenter(aug_params, dev).augment_first_frame(
                frame, mask, np.random.RandomState(0))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            tda.batch_augment = inner
        if dev == "cpu":
            cpu_seconds = seconds
    batches["host"] = ImageAugmenter(aug_params, "cuda").augment_first_frame(
        frame, mask, np.random.RandomState(0))

    def gap(a, b):
        d = (a[0].cpu().float() - b[0].cpu().float()).abs()
        return {"labels_equal": bool(torch.equal(a[1].cpu(), b[1].cpu())),
                "label_agreement": float((a[1].cpu() == b[1].cpu()).float().mean()),
                "image_max_abs_diff": float(d.max()),
                "image_share_differing": float((d > 0).float().mean())}
    card_vs_cpu, device_vs_host = gap(batches["cuda"], batches["cpu"]), \
        gap(batches["cuda"], batches["host"])

    per_round = augment_round_readings()

    bf16 = replace(cfg, compute_dtype="bfloat16")
    readings, labels = augment_backend_readings(bf16, backbone, refiner, n_objects=2)
    agreement = [float(np.mean(a == b)) for a, b in zip(labels["device"], labels["host"])]
    sensitivity = augment_gap_sensitivity(
        bf16, backbone, refiner, device_vs_host["image_share_differing"])
    # the two backends' augment batches differ by one grey level on a share
    # of their values (the CPU test's bound: under 0.1 %); the yardstick
    # moves the host backend's own values by that share at other, seeded
    # positions. The backends' label gap a frame stays within twice the
    # yardstick's largest movement (positions other than the yardstick's
    # may move labels as much again) plus the CPU tracker test's 0.5 %.
    gap_limit = 2 * max(sensitivity) + 0.005
    emit({"phase": "device_augment", "card": card, "arch": cfg.feature_extractor,
          "size": [480, 854], "dtype": "bfloat16", "objects": 2, "frames": 9,
          "augment_counts_per_round": counts["cuda"], "card_vs_cpu": card_vs_cpu,
          "cpu_augment_s": cpu_seconds, "device_vs_host_augmenter": device_vs_host,
          "round_at_4_specs": per_round[4], "round_at_19_specs": per_round[19],
          "backends": readings, "tracker_label_agreement_device_vs_host": agreement,
          "host_tracker_label_movement_under_augment_gap": sensitivity,
          "tracker_label_gap_limit": gap_limit,
          "tolerance": {"image_max_abs_diff": 1.0, "image_share_differing": 1e-3}})
    if counts["cuda"] != counts["cpu"]:
        fail(f"device_augment: visibility counts on the card {counts['cuda']} differ from the "
             f"CPU's {counts['cpu']}")
    for name, g in (("card vs CPU", card_vs_cpu), ("device vs host augmenter", device_vs_host)):
        if not g["labels_equal"] or g["image_max_abs_diff"] > 1.0 \
                or g["image_share_differing"] >= 1e-3:
            fail(f"device_augment ({name}): {g}")
    if max(1 - a for a in agreement) > gap_limit:
        fail(f"device_augment: the backends' labels differ by up to "
             f"{max(1 - a for a in agreement)} of a frame, over {gap_limit}")
    r4, r19 = per_round[4], per_round[19]
    if r4["rounds"] != 1 or r19["rounds"] != 1 or not r4["kernels"] \
            or r4["kernels"] != r19["kernels"] or r4["launches"] != r19["launches"]:
        fail(f"device_augment: one round at 4 and at 19 specs launched differently: {r4}, {r19}")
    if not r19["warp_variants"]["staged_batched"] or r19["warp_variants"]["staged"] \
            or r19["warp_variants"]["direct"]:
        fail(f"device_augment: the round took no batched warp variant: {r19['warp_variants']}")
    dev = readings["device"]
    n_warps = dev["launches_timed_passes"]["warp_affine"]
    if dev["warp_variants_per_pass"]["staged_batched"] != dev["launches_per_pass"]["warp_affine"] \
            or n_warps % 3 or n_warps < 3 * 2 * 3:
        fail(f"device_augment: expected 3 batched warps per round, at least one round per "
             f"object and pass, all staged, got {dev['launches_timed_passes']}, "
             f"{dev['warp_variants_per_pass']}")
    return dev["launches_timed_passes"], readings


def augment_gap_sensitivity(cfg, backbone, refiner, share, n_objects=2, n_frames=9):
    """The yardstick for the two backends' label agreement: the host
    backend's fused tracker on the device_augment sequence, once on its own
    augment batches and once on the same batches with `share` of their
    image values (the share the device augmenter's differ on) moved by one
    grey level at seeded positions; per frame, the share of labels that
    moved."""
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    seq = make_moving_square_sequence(n_frames=n_frames, size=(480, 854), square=120,
                                      n_objects=n_objects, seed=0)
    tracker = BatchedSequenceTracker(cfg, backbone, refiner, device="cuda")
    batches = tracker._augment_objects(tracker._collect_objects(seq))
    g = torch.Generator(device="cpu").manual_seed(0)
    moved = []
    for ims, lbs in batches:
        flat = ims.flatten().clone()
        n = max(1, round(share * flat.numel()))
        pos = torch.randperm(flat.numel(), generator=g)[:n].to(flat.device)
        step = torch.where(flat[pos] < 255, 1, -1).to(torch.int16)
        flat[pos] = (flat[pos].to(torch.int16) + step).to(torch.uint8)
        moved.append((flat.view_as(ims), lbs))
    base, _ = tracker.run_sequence(seq, aug_batches=batches)
    nudged, _ = tracker.run_sequence(seq, aug_batches=moved)
    return [float(np.mean(a != b)) for a, b in zip(base, nudged)]


class SyntheticDataset:
    """Synthetic sequences behind the interface the CLI reads of a dataset:
    a name, iteration over sequences, and per sequence the ground-truth
    annotation files (`annos`), written here as indexed PNGs."""

    def __init__(self, name, sequences, anno_root):
        from frtm_tpu_torch.data.image import imwrite_indexed
        self.name = name
        self.sequences = sequences
        self.all_annotations = False
        for seq in sequences:
            (anno_root / seq.name).mkdir(parents=True)
            seq.annos = []
            for frame, labels in zip(seq.frame_names, seq.labels):
                seq.annos.append(anno_root / seq.name / f"{frame}.png")
                imwrite_indexed(seq.annos[-1], labels)

    def __len__(self):
        return len(self.sequences)

    def __getitem__(self, i):
        return self.sequences[i]


def phase_eval(cfg, backbone, refiner):
    """This slice's path: the evaluation CLI in bfloat16 on fabricated
    checkpoints and a synthetic dataset, without and with --pipeline."""
    from dataclasses import replace
    from frtm_tpu_torch import evaluate
    from frtm_tpu_torch.data.image import imread
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.ops.kernels import LAUNCHES, VARIANTS, reset_launches
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker

    n_seqs, n_frames, n_objects = 3, 25, 2
    tracked = n_frames - 1
    windows = -(-tracked // cfg.disc.train_skipping)
    expected = {"pyrup": 2 * windows * n_seqs, "conv3x3_cout1": windows * n_seqs,
                "warp_affine": 4 * n_objects * n_seqs}

    recorded = {}           # run tag -> {sequence name: (labels, fps)}
    enqueue = {}            # run tag -> {sequence name: {phase: host seconds}}
    original = BatchedSequenceTracker.run_sequence

    def recording(self, sequence, *args, **kwargs):
        out = original(self, sequence, *args, **kwargs)
        recorded.setdefault(self.run_tag, {})[sequence.name] = out
        enqueue.setdefault(self.run_tag, {})[sequence.name] = {
            k: v["total_s"] for k, v in self.last_phase_stats.items()}
        return out

    walls = {}              # run tag -> seconds inside run_dataset (tracking and PNG writes)
    original_dataset = BatchedSequenceTracker.run_dataset

    def timed_dataset(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = original_dataset(self, *args, **kwargs)
        walls[self.run_tag] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory(prefix="frtm_smoke_") as tmp:
        tmp = Path(tmp)
        # the reference's trainer checkpoint (refiner.* keys under "model";
        # the head is the one `decode` scaled) and a torchvision-format backbone
        saved_refiner = {k: v.detach().cpu().clone() for k, v in refiner.state_dict().items()}
        saved_backbone = {k: v.detach().cpu().clone() for k, v in backbone.state_dict().items()}
        torch.save({"model": {"refiner." + k: v for k, v in saved_refiner.items()},
                    "epoch": 260}, tmp / "rn101_smoke.pth")
        torch.save(saved_backbone, tmp / "resnet101.pth")
        seqs = [make_moving_square_sequence(n_frames=n_frames, size=(480, 854), square=120,
                                            n_objects=n_objects, seed=20 + i, name=f"synth{i}")
                for i in range(n_seqs)]
        dataset = SyntheticDataset("synthval", seqs, tmp / "annotations")
        argv = ["--model", str(tmp / "rn101_smoke.pth"), "--backbone", str(tmp / "resnet101.pth"),
                "--dset", "dv2017val", "--dev", "cuda", "--dtype", "bfloat16",
                "--engine", "fused"]

        runs = {}
        BatchedSequenceTracker.run_sequence = recording
        BatchedSequenceTracker.run_dataset = timed_dataset
        try:
            # the last two runs read the committed DAVIS tree from disk: no
            # dataset object, the CLI's own DAVISDataset and JPEG decoder; the
            # last one with the committed frtm_tpu .npz model (a resnet18-width
            # refiner, with no --backbone: a seeded random backbone)
            davis_args = ["--davis", str(FIXTURES / "davis")]
            npz_argv = ["--model", str(FIXTURES / "models" / "rn18_refiner.npz"),
                        "--dset", "dv2017val", "--dev", "cuda", "--dtype", "bfloat16",
                        "--engine", "fused"]
            for tag, args, dset in (("plain", argv, dataset),
                                    ("pipelined", argv + ["--pipeline"], dataset),
                                    ("davis", argv + davis_args, None),
                                    ("npz", npz_argv + davis_args, None)):
                BatchedSequenceTracker.run_tag = tag
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                text = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    result = evaluate.main(args + ["--output", str(tmp / tag)], dataset=dset)
                torch.cuda.synchronize()
                runs[tag] = dict(result, wall_s=time.perf_counter() - t0,
                                 launches=dict(LAUNCHES),
                                 variants={k: dict(v) for k, v in VARIANTS.items()},
                                 peak=torch.cuda.max_memory_allocated(), text=text.getvalue())
                print(text.getvalue(), end="", flush=True)
        finally:
            BatchedSequenceTracker.run_sequence = original
            BatchedSequenceTracker.run_dataset = original_dataset
            del BatchedSequenceTracker.run_tag

        # the loaded models are the saved tensors
        tracker = runs["plain"]["tracker"]
        for name, module, saved in (("refiner", tracker.refiner, saved_refiner),
                                    ("backbone", tracker.backbone, saved_backbone)):
            loaded = module.state_dict()
            if set(loaded) != set(saved) or not all(
                    torch.equal(loaded[k].cpu(), saved[k]) for k in saved):
                fail(f"eval: the loaded {name} is not the saved one")
        if tracker.cfg.compute_dtype != "bfloat16" or tracker.last_feats_dtype != torch.bfloat16 \
                or tracker.extract_chunk != 16 \
                or tracker.cfg.feature_extractor != cfg.feature_extractor:
            fail(f"eval: the CLI did not build the {cfg.feature_extractor} bfloat16 tracker "
                 "with extract_chunk=16")

        # PNGs: all there, equal to what run_sequence returned, frame 0 the
        # ground truth, the pipelined run's equal byte for byte
        davis = runs.pop("davis")
        npz = runs.pop("npz")
        for tag, run in runs.items():
            if run["out_path"] != (tmp / tag).resolve() / "synthval-rn101_smoke":
                fail(f"eval: results went to {run['out_path']}")
            for seq in seqs:
                labels, _ = recorded[tag][seq.name]
                files = sorted((run["out_path"] / seq.name).glob("*.png"))
                if [f.stem for f in files] != seq.frame_names or len(labels) != n_frames:
                    fail(f"eval ({tag}): {seq.name} has {len(files)} PNGs, {len(labels)} labels")
                for f, lb in zip(files, labels):
                    if not np.array_equal(imread(f)[..., 0], lb):
                        fail(f"eval ({tag}): {f.name} of {seq.name} is not what was tracked")
                    if tag == "pipelined" and f.read_bytes() != (
                            runs["plain"]["out_path"] / seq.name / f.name).read_bytes():
                        fail(f"eval: {seq.name}/{f.name} differs between the pipelined run "
                             "and the other")
                if not np.array_equal(labels[0], seq.labels[0][..., 0]):
                    fail(f"eval ({tag}): frame 0 of {seq.name} is not the ground truth")
                lost = [i for i in range(1, n_objects + 1)
                        if min(int((lb == i).sum()) for lb in labels[1:]) == 0]
                if lost:
                    fail(f"eval ({tag}): objects {lost} are missing from a frame of {seq.name}")
            # both reports, their last line the returned dataset mean
            for measure in ("J", "F"):
                report = run["out_path"] / f"evaluation-{measure}.txt"
                if not report.exists():
                    fail(f"eval ({tag}): {report.name} is missing")
                last = report.read_text().splitlines()[-1]
                if not (np.isfinite(run[measure]) and 0.0 <= run[measure] <= 1.0
                        and last.startswith(f"{measure}: {run[measure]:.3f}, recall: ")):
                    fail(f"eval ({tag}): report ends {last!r}, returned {run[measure]}")
            # launches: what the code implies, all decodes in bfloat16, all warps staged
            ln, vr = run["launches"], run["variants"]
            if {k: ln[k] for k in expected} != expected:
                fail(f"eval ({tag}): expected launches {expected}, got {ln}")
            if vr["pyrup"] != {"f32": 0, "bf16": expected["pyrup"]} \
                    or vr["conv3x3_cout1"] != {"f32": 0, "bf16": expected["conv3x3_cout1"]} \
                    or vr["warp_affine"] != {"staged": expected["warp_affine"], "direct": 0,
                                             "staged_batched": 0, "direct_batched": 0}:
                fail(f"eval ({tag}): every decode launch must take the bfloat16 instance and "
                     f"every warp the staged one, got {vr}")
        if (runs["plain"]["J"], runs["plain"]["F"]) != (runs["pipelined"]["J"],
                                                          runs["pipelined"]["F"]):
            fail("eval: the pipelined run scored differently")
        if "(ex-augment)" in runs["plain"]["text"] \
                or runs["pipelined"]["text"].count("(ex-augment)") != n_seqs:
            fail("eval: the per-sequence fps lines are not tagged as the protocol says")
        aggregate = [ln for ln in runs["pipelined"]["text"].splitlines()
                     if ln.startswith("Pipelined dataset pass: ")]
        if len(aggregate) != 1:
            fail("eval: the pipelined run printed no aggregate line")

        davis_checks = check_davis_run(davis, recorded["davis"], tmp / "davis")
        npz_checks = check_davis_run(npz, recorded["npz"], tmp / "npz", "rn18_refiner")
        if npz["tracker"].cfg.feature_extractor != "resnet18" \
                or "no --backbone weights given" not in npz["text"]:
            fail("eval (npz): the CLI did not build the fixture's resnet18 tracker")

        # per sequence: fps and the host's cut-and-inpaint of its objects
        from frtm_tpu_torch.data.datasets import DAVISDataset
        davis_seqs = list(DAVISDataset(FIXTURES / "davis", "2017", "val"))
        per_sequence = {
            tag: {seq.name: {"fps": recorded[tag][seq.name][1],
                             "host_cut_inpaint_s": cut_inpaint_seconds(*seq[0][:2]),
                             "augment_host_s": enqueue[tag][seq.name].get("augment")}
                  for seq in (davis_seqs if tag == "davis" else seqs)}
            for tag in ("plain", "pipelined", "davis")}

        # the first sequence again, its augment batches made once and handed
        # to every pass (the augment is the host's and the same in both
        # types): on the CLI's tracker, timed and then with a synchronise at
        # every phase edge (phase seconds, the scan's host waits), and the
        # same through a float32 tracker of the same weights (the label gap)
        batches = tracker._augment_objects(tracker._collect_objects(seqs[0]))

        def passes(tr):
            tr.run_sequence(seqs[0], aug_batches=batches)    # first launches in this type
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out, fps = tr.run_sequence(seqs[0], aug_batches=batches)
            peak = torch.cuda.max_memory_allocated()
            tr.profile = True
            _, fps_profiled = tr.run_sequence(seqs[0], aug_batches=batches)
            tr.profile = False
            stats = tr.last_phase_stats
            return {"labels": out, "fps_ex_augment": fps, "fps_ex_augment_profiled": fps_profiled,
                    "phase_seconds": {k: v["total_s"] for k, v in stats.items()},
                    "scan_host_syncs": stats["scan"]["host_syncs"],
                    "scan_host_syncs_at": stats["scan"]["host_syncs_at"],
                    "max_memory_allocated": peak}

        bf16 = passes(tracker)
        rerun_diff = max(float(np.mean(a != b)) for a, b in zip(
            bf16["labels"], recorded["plain"][seqs[0].name][0]))
        f32 = passes(BatchedSequenceTracker(replace(cfg, compute_dtype="float32"), backbone,
                                            refiner, extract_chunk=16, device="cuda"))
        gap = [float(np.mean(a != b)) for a, b in zip(bf16.pop("labels"), f32.pop("labels"))]

    emit({"phase": "eval", "arch": cfg.feature_extractor, "dtype": "bfloat16", "engine": "fused",
          "sequences": n_seqs, "frames": n_frames, "objects": n_objects, "size": [480, 854],
          "windows_per_sequence": windows,
          "fps_per_sequence": {t: {n: fps for n, (_, fps) in recorded[t].items()}
                               for t in runs},
          "fps_average": {t: r["fps"] for t, r in runs.items()},
          "pipelined_aggregate_line": aggregate[0],
          "pipelined_aggregate_fps": float(aggregate[0].split()[3]),
          "run_dataset_wall_s": walls,
          "run_dataset_fps": {t: n_seqs * n_frames / w for t, w in walls.items()},
          "wall_s_with_load_and_scoring": {t: r["wall_s"] for t, r in runs.items()},
          "per_sequence": per_sequence, "davis_tree": davis_checks,
          "davis_tree_npz_model": npz_checks,
          "J": runs["plain"]["J"], "F": runs["plain"]["F"],
          "launches": {t: r["launches"] for t, r in runs.items()},
          "instances": {t: r["variants"] for t, r in runs.items()},
          "max_memory_allocated": {t: r["peak"] for t, r in runs.items()},
          "host_seconds_per_phase": enqueue,
          "first_sequence": {
              "fps_cli_run": recorded["plain"][seqs[0].name][1],
              "bf16": bf16, "float32": f32,
              "label_mismatch_bf16_rerun_max": rerun_diff,
              "label_gap_bf16_vs_float32": gap, "label_gap_bf16_vs_float32_max": max(gap)},
          "tolerance": {"label_gap_bf16_vs_float32": 5e-2}})
    if bf16["scan_host_syncs"] != 0:
        fail(f"eval: the scan waited for the card {bf16['scan_host_syncs']} times: "
             f"{bf16['scan_host_syncs_at']}")
    if rerun_diff != 0:
        fail(f"eval: a re-run of the CLI's tracker differs on {rerun_diff:.4%} of a frame")
    if not max(gap) <= 5e-2:
        fail(f"eval: bfloat16 labels differ from float32 on {max(gap):.2%} of a frame")
    counted = (runs["plain"], davis, npz)
    return ({k: sum(r["launches"][k] for r in counted) for k in expected},
            {k: {i: sum(r["variants"][k][i] for r in counted)
                 for i in runs["plain"]["variants"][k]} for k in expected})


def phase_ytvos(backbone, refiner):
    """The YouTube-VOS entry point on the committed 720x1280 tree, in bf16:
    legacy configuration, deferred merge, object 2 entering at frame 4."""
    from frtm_tpu_torch import evaluate_ytvos
    from frtm_tpu_torch.data.datasets import YouTubeVOSDataset
    from frtm_tpu_torch.data.image import imread
    from frtm_tpu_torch.ops.kernels import LAUNCHES, VARIANTS, reset_launches
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker

    tree = FIXTURES / "ytvos"
    name, n_frames, entry = "0a1b2c3d4e", 9, 4
    anno = tree / "valid" / "Annotations" / name
    # the per-frame loop (entry at 4 is not on a window of 8): 8 decodes of 2 lanes
    expected = {"pyrup": 16, "conv3x3_cout1": 8, "warp_affine": 8}
    recorded = []
    original = BatchedSequenceTracker.run_sequence

    def recording(self, sequence, *args, **kwargs):
        out = original(self, sequence, *args, **kwargs)
        recorded.append((sequence.name, out, {k: v["total_s"]
                                              for k, v in self.last_phase_stats.items()}))
        return out

    with tempfile.TemporaryDirectory(prefix="frtm_smoke_yt_") as tmp:
        tmp = Path(tmp)
        torch.save({"model": {"refiner." + k: v.detach().cpu()
                              for k, v in refiner.state_dict().items()}, "epoch": 260},
                   tmp / "rn101_ytvos.pth")
        torch.save({k: v.detach().cpu() for k, v in backbone.state_dict().items()},
                   tmp / "resnet101.pth")
        argv = ["--model", str(tmp / "rn101_ytvos.pth"), "--backbone", str(tmp / "resnet101.pth"),
                "--yt2018", str(tree), "--dev", "cuda", "--dtype", "bfloat16"]
        runs = {}
        BatchedSequenceTracker.run_sequence = recording
        try:
            for tag in ("first", "rerun"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                text = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    result = evaluate_ytvos.main(argv + ["--output", str(tmp / tag)])
                torch.cuda.synchronize()
                runs[tag] = dict(result, wall_s=time.perf_counter() - t0, launches=dict(LAUNCHES),
                                 variants={k: dict(v) for k, v in VARIANTS.items()},
                                 peak=torch.cuda.max_memory_allocated(), text=text.getvalue())
                print(text.getvalue(), end="", flush=True)
        finally:
            BatchedSequenceTracker.run_sequence = original

        run = runs["first"]
        tracker = run["tracker"]
        res = run["out_path"]
        if res != (tmp / "first").resolve() / "ytvos2018valid_all_frames" / "Annotations":
            fail(f"ytvos: results went to {res}")
        if tracker.merge_mode != "deferred" or tracker.cfg.disc.update_method != "thresh" \
                or tracker.last_feats_dtype != torch.bfloat16:
            fail("ytvos: the CLI did not build the deferred-merge, thresh-update bf16 tracker")
        (seq_name, (labels, fps), phases), _ = recorded
        files = sorted((res / name).glob("*.png"))
        if seq_name != name or [f.stem for f in files] != [f"{t:05d}" for t in range(n_frames)]:
            fail(f"ytvos: {seq_name}: PNGs {[f.name for f in files]}")
        for f, lb in zip(files, labels):
            if lb.shape != (720, 1280) or not np.array_equal(imread(f)[..., 0], lb):
                fail(f"ytvos: {f.name} is not what was tracked")
            if f.read_bytes() != (runs["rerun"]["out_path"] / name / f.name).read_bytes():
                fail(f"ytvos: {f.name} differs in a re-run")
        gt0 = imread(anno / "00000.png")[..., 0]
        gt_entry = imread(anno / f"{entry:05d}.png")[..., 0] == 2
        if not np.array_equal(labels[0], gt0):
            fail("ytvos: frame 0 is not object 1's ground truth")
        if any((lb == 2).any() for lb in labels[:entry]):
            fail("ytvos: object 2 is labelled before it enters")
        covered = float(((labels[entry] == 2) & gt_entry).sum() / gt_entry.sum())
        if covered < 0.9:
            fail(f"ytvos: object 2 covers {covered:.2%} of its ground truth at its entry frame")
        for tag, r in runs.items():
            ln, vr = r["launches"], r["variants"]
            if {k: ln[k] for k in expected} != expected or vr["pyrup"]["f32"] \
                    or vr["conv3x3_cout1"]["f32"] or vr["warp_affine"]["staged"] != 8:
                fail(f"ytvos ({tag}): expected launches {expected}, all bf16 / staged, "
                     f"got {ln}, {vr}")

        # the scan's host waits, and phase seconds from a synchronised pass
        seq = YouTubeVOSDataset(tree, "2018", "valid_all_frames")[0]
        seq.preload()
        tracker.profile = True
        _, fps_profiled = tracker.run_sequence(seq)
        tracker.profile = False
        stats = tracker.last_phase_stats
        host_syncs = stats["scan"]["host_syncs"]
        if host_syncs != 0:
            fail(f"ytvos: the scan waited for the card {host_syncs} times: "
                 f"{stats['scan']['host_syncs_at']}")

        # a decode at 720x1280 in bf16 (pyrup on (2, 32, 180, 320) and
        # (2, 16, 360, 640), the head conv on (2, 16, 720, 1280)): kernels
        # against plain within one bf16 ulp at the logits' peak
        from frtm_tpu_torch.models.seg_network import seg_network_apply
        im = torch.from_numpy(seq.preloaded[1]).cuda().permute(2, 0, 1)[None]
        feats = tracker.backbone_c.extract_features(im, output_layers=tracker._all_layers,
                                                    out_dtype=torch.bfloat16)
        layers = tracker.cfg.refnet_layers
        feats = {L: feats[L].expand(2, -1, -1, -1) for L in layers}
        g = torch.Generator().manual_seed(3)
        scores = (torch.randn((2, 1) + tuple(feats["layer4"].shape[-2:]), generator=g) * 2).cuda()

        def decode():
            return seg_network_apply(tracker.refiner_c, scores.to(torch.bfloat16), feats,
                                     (720, 1280), layers=layers)
        reset_launches()
        with torch.no_grad():
            got = decode()
            instances = {k: dict(VARIANTS[k]) for k in ("pyrup", "conv3x3_cout1")}
            with plain_decoder():
                want = decode()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = bf16_ulp(float(want.float().abs().max()))
        if instances != {"pyrup": {"f32": 0, "bf16": 2}, "conv3x3_cout1": {"f32": 0, "bf16": 1}} \
                or err > tol:
            fail(f"ytvos: the 720x1280 bf16 decode: kernels vs plain {err} (tolerance {tol}), "
                 f"instances {instances}")

    emit({"phase": "ytvos", "arch": tracker.cfg.feature_extractor, "dtype": "bfloat16",
          "merge_mode": "deferred", "update_method": "thresh", "size": [720, 1280],
          "frames": n_frames, "objects": 2, "entry_frame": entry, "fps": fps,
          "fps_profiled": fps_profiled, "fps_rerun": runs["rerun"]["fps"],
          "host_seconds_per_phase": phases,
          "phase_seconds": {k: v["total_s"] for k, v in stats.items()},
          "host_cut_inpaint_s": cut_inpaint_seconds(seq[0][0], gt0)
          + cut_inpaint_seconds(seq[entry][0], gt_entry.astype(np.uint8) * 2),
          "scan_host_syncs": host_syncs, "launches": run["launches"],
          "instances": run["variants"], "max_memory_allocated": run["peak"],
          "wall_s": run["wall_s"], "object2_entry_coverage": covered,
          "object_pixels": {i: [int((lb == i).sum()) for lb in labels] for i in (1, 2)},
          "decode_720x1280_bf16": {"max_abs_err": err, "tolerance": tol,
                                   "instances": instances},
          "rerun_equal": True})
    return run["launches"], run["variants"]


def cut_inpaint_seconds(image, labels):
    """Host seconds of the augmenter's cut and Telea inpaint, once per object
    of a start frame (what the augment phase spends on them)."""
    from frtm_tpu_torch.models.augmenter import cut_and_inpaint
    labels = np.asarray(labels).squeeze()
    t0 = time.perf_counter()
    for obj in np.unique(labels)[1:]:
        cut_and_inpaint(image, labels == obj)
    return time.perf_counter() - t0


def check_davis_run(run, recorded, out_root, model="rn101_smoke"):
    """The CLI's run over the committed DAVIS tree: 9 PNGs equal to what was
    tracked, frame 0 the ground truth, both reports, launches of one window
    of two objects (4 warps each, one per accepted spec), all bf16 /
    staged."""
    from frtm_tpu_torch.data.image import imread
    anno = FIXTURES / "davis" / "Annotations" / "480p" / "blobs"
    if run["out_path"] != out_root.resolve() / f"dv2017val-{model}" or list(recorded) != ["blobs"]:
        fail(f"eval (davis): results went to {run['out_path']}, sequences {list(recorded)}")
    labels, fps = recorded["blobs"]
    files = sorted((run["out_path"] / "blobs").glob("*.png"))
    if [f.stem for f in files] != [f"{t:05d}" for t in range(9)] or len(labels) != 9:
        fail(f"eval (davis): {len(files)} PNGs, {len(labels)} labels, expected 9")
    for f, lb in zip(files, labels):
        if lb.shape != (480, 854) or not np.array_equal(imread(f)[..., 0], lb):
            fail(f"eval (davis): {f.name} is not what was tracked")
    if not np.array_equal(labels[0], imread(anno / "00000.png")[..., 0]):
        fail("eval (davis): frame 0 is not the ground truth")
    for measure in ("J", "F"):
        last = (run["out_path"] / f"evaluation-{measure}.txt").read_text().splitlines()[-1]
        if not (np.isfinite(run[measure]) and last.startswith(f"{measure}: {run[measure]:.3f}")):
            fail(f"eval (davis): report ends {last!r}, returned {run[measure]}")
    want = {"pyrup": 2, "conv3x3_cout1": 1, "warp_affine": 8}
    ln, vr = run["launches"], run["variants"]
    if {k: ln[k] for k in want} != want or vr["pyrup"]["bf16"] != 2 \
            or vr["conv3x3_cout1"]["bf16"] != 1 or vr["warp_affine"]["staged"] != 8:
        fail(f"eval (davis): expected launches {want}, all bf16 / staged, got {ln}, {vr}")
    return {"fps": fps, "frames": len(labels), "J": run["J"], "F": run["F"],
            "launches": ln, "wall_s_with_load_and_scoring": run["wall_s"],
            "max_memory_allocated": run["peak"],
            "object_pixels": {i: [int((lb == i).sum()) for lb in labels] for i in (1, 2)}}


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
        resolves[dev] = int(tr.targets[1].state.n_resolves)
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


def write_training_trees(root):
    """A DAVIS-train tree of the committed DAVIS frames (ImageSets/2017/
    train.txt names `blobs`) and a YouTube-VOS-train tree of the committed
    720x1280 frames under the first jjtrain name, its 9 annotations written
    with the port's PNG writer: frames 0-3 from 00000.png (object 1), 4-8
    from 00004.png (objects 1 and 2)."""
    import shutil
    from frtm_tpu_torch.data.image import imread, imwrite_indexed
    davis, ytvos = root / "DAVIS", root / "ytvos2018"
    src = FIXTURES / "davis"
    for sub in ("JPEGImages", "Annotations"):
        shutil.copytree(src / sub / "480p" / "blobs", davis / sub / "480p" / "blobs")
    (davis / "ImageSets" / "2017").mkdir(parents=True)
    (davis / "ImageSets" / "2017" / "train.txt").write_text("blobs\n")
    name = (ROOT / "frtm_tpu_torch" / "data" / "ytvos_jjtrain.txt").read_text().split()[0]
    yt = FIXTURES / "ytvos"
    shutil.copytree(yt / "valid_all_frames" / "JPEGImages" / "0a1b2c3d4e",
                    ytvos / "train" / "JPEGImages" / name)
    anno = ytvos / "train" / "Annotations" / name
    anno.mkdir(parents=True)
    for t in range(9):
        src_png = yt / "valid" / "Annotations" / "0a1b2c3d4e" / ("00000.png" if t < 4 else "00004.png")
        imwrite_indexed(anno / f"{t:05d}.png", imread(src_png))
    return davis, ytvos


def train_step_grads(model, disc, images, labels, mask):
    """Loss and every refiner gradient of one train step (no update)."""
    model.refiner.zero_grad(set_to_none=True)
    total, acc = model.loss(disc, images, labels, mask)
    total.backward()
    return float(total.detach()), {n: p.grad.detach().cpu().clone()
                                   for n, p in model.refiner.named_parameters()}


def phase_train_small(arch="resnet18"):
    """One train step of a small batch (rn18, 96x128, batch 4, the same
    target models) on the CPU (plain versions) and twice on the card."""
    from dataclasses import replace
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.training_datasets import SampleSpec, SyntheticTrainingDataset
    from frtm_tpu_torch.models.discriminator import DiscParams
    from frtm_tpu_torch.runtime.trainer import TModelCache, TrainerModel
    cfg = eval_config(arch, fast=True, num_aug=3)
    cfg = replace(cfg, disc=replace(cfg.disc, c_channels=16, init_iters=(3, 5), update_iters=(3,),
                                    memory_size=8, filter_reg=(1e-5, 1e-4),
                                    precond=(1e-5, 1e-4), cg_forgetting_rate=75,
                                    pixel_weighting_method="none"))
    dset = SyntheticTrainingDataset(n_samples=4, size=(96, 128), sample_size=3, seed=0)
    items = [dset[i] for i in range(4)]
    images = np.stack([np.stack([it[0][t] for it in items]) for t in range(3)])
    labels = np.stack([np.stack([it[1][t] for it in items]) for t in range(3)])
    mask = np.asarray([1, 1, 1, 0], np.float32)
    models = {dev: TrainerModel(cfg, *build_models(arch, cfg, dev), TModelCache(None, False),
                                device=dev) for dev in ("cpu", "cuda")}
    disc, _ = models["cpu"].build_disc_batch(images[0], labels[0],
                                             SampleSpec.from_encoded([it[2] for it in items]))
    loss_cpu, g_cpu = train_step_grads(models["cpu"], disc, images, labels, mask)
    disc_card = DiscParams(disc.project.cuda(), disc.filter.cuda())
    sd = {k: v.clone() for k, v in models["cuda"].refiner.state_dict().items()}
    loss_card, g_card = train_step_grads(models["cuda"], disc_card, images, labels, mask)
    models["cuda"].refiner.load_state_dict(sd)
    loss_again, g_again = train_step_grads(models["cuda"], disc_card, images, labels, mask)
    errs = {}
    for n, want in g_cpu.items():
        if n.endswith("bblock.0.bias"):
            # exact gradient 0 (the batch-statistics BN removes the mean):
            # rounding noise on both sides, against the conv's weight gradient
            scale = float(g_cpu[n.replace("bias", "weight")].abs().max())
            errs[n] = max(float(want.abs().max()), float(g_card[n].abs().max())) / scale
        else:
            errs[n] = float((g_card[n] - want).abs().max() / want.abs().max())
    worst = max(errs, key=errs.get)
    rerun_equal = loss_again == loss_card and all(torch.equal(g_again[n], g_card[n]) for n in g_card)
    out = {"arch": arch, "size": [96, 128], "batch": 4, "loss_cpu": loss_cpu,
           "loss_card": loss_card, "loss_rel_gap": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "grad_gap_max_of_peak": errs[worst], "grad_gap_worst": worst,
           "rerun_bit_equal": rerun_equal, "tolerance": {"loss_rtol": 1e-4, "grad_of_peak": 1e-3}}
    if out["loss_rel_gap"] > 1e-4 or errs[worst] > 1e-3 or not rerun_equal:
        emit({"phase": "train_small", **out})
        fail("train: the card's train step disagrees with the CPU's, or a re-run differs")
    return out


def phase_train(backbone, card):
    """The training entry point: 2 epochs on the DAVIS and YouTube-VOS trees
    (batch 16, rn101, 480x854), then a resumed third."""
    import json as _json
    from frtm_tpu_torch import train
    from frtm_tpu_torch.ops.kernels import LAUNCHES, VARIANTS, reset_launches
    from frtm_tpu_torch.runtime.trainer import Trainer, TrainerModel
    from frtm_tpu_torch.utils.convert import init_seg_network
    from frtm_tpu_torch.models.resnet import resnet_out_channels

    init_model, load_ckpt, build_batch, train_step = (
        TrainerModel.__init__, Trainer.load_checkpoint, TrainerModel.build_disc_batch,
        TrainerModel.train_step)
    keys, loaded, step_seconds, solved = [], {}, [], []

    def profiled_init(self, *args, **kwargs):
        init_model(self, *args, **dict(kwargs, profile=True))

    def recording_load(self, file):
        load_ckpt(self, file)
        loaded.update(epoch=self.epoch, file=Path(file).name, refiner={
            k: v.detach().cpu().clone() for k, v in self.model.refiner.state_dict().items()})

    def recording_batch(self, first_images, first_labels, specs):
        keys.extend((s.seq_name, s.frame0_id, s.obj_id) for s in specs)
        step_seconds.append(time.perf_counter())
        out = build_batch(self, first_images, first_labels, specs)
        solved.append(len(specs) - out[1])    # target models solved here, not read
        return out

    def timed_step(self, *args):
        out = train_step(self, *args)      # ends in a host read of the loss
        step_seconds[-1] = time.perf_counter() - step_seconds[-1]
        return out

    runs = {}
    with tempfile.TemporaryDirectory(prefix="frtm_train_") as tmp:
        tmp = Path(tmp)
        davis, ytvos = write_training_trees(tmp)
        torch.save({k: v.detach().cpu() for k, v in backbone.state_dict().items()},
                   tmp / "resnet101.pth")
        argv = ["smoke", "--ftext", "resnet101", "--dset", "all", "--dv2017", str(davis),
                "--yt2018", str(ytvos), "--workspace", str(tmp / "ws"), "--backbone",
                str(tmp / "resnet101.pth"), "--dev", "cuda", "--batch-size", "16"]
        TrainerModel.__init__, Trainer.load_checkpoint = profiled_init, recording_load
        TrainerModel.build_disc_batch, TrainerModel.train_step = recording_batch, timed_step
        try:
            for tag, epochs in (("epochs_1_2", 2), ("resumed", 3)):
                keys.clear()
                step_seconds.clear()
                solved.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                text = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    trainer = train.main(argv + ["--max-epochs", str(epochs)])
                torch.cuda.synchronize()
                runs[tag] = dict(trainer=trainer, wall_s=time.perf_counter() - t0,
                                 step_seconds=list(step_seconds), solved=sum(solved),
                                 launches=dict(LAUNCHES),
                                 variants={k: dict(v) for k, v in VARIANTS.items()},
                                 peak=torch.cuda.max_memory_allocated(), keys=list(set(keys)),
                                 timer=trainer.model.timer.stats(), text=text.getvalue(),
                                 stats=[_json.loads(x) for x in (
                                     tmp / "ws" / "logs" / "smoke" / "stats.jsonl").open()])
                print(text.getvalue(), end="", flush=True)
                if tag == "epochs_1_2":
                    ckpts = sorted(p.name for p in (tmp / "ws" / "checkpoints" / "smoke").glob("*.pth"))
                    n_cache = len(list((tmp / "ws" / "tmodels_cache").rglob("*.npz")))
                    saved = torch.load(tmp / "ws" / "checkpoints" / "smoke" / "smoke_ep0002.pth",
                                       map_location="cpu", weights_only=True)["refiner"]
        finally:
            TrainerModel.__init__, Trainer.load_checkpoint = init_model, load_ckpt
            TrainerModel.build_disc_batch, TrainerModel.train_step = build_batch, train_step

    first, resumed = runs["epochs_1_2"], runs["resumed"]
    stats = first["stats"]
    ok_stats = len(stats) == 2 and all(np.isfinite(st["stats/loss"]) and np.isfinite(
        st["stats/accuracy"]) for st in stats) and [st["epoch"] for st in stats] == [1, 2]
    if not ok_stats or stats[1]["stats/fcache_hits"] <= 0:
        fail(f"train: stats.jsonl reads {stats}")
    if n_cache != len(first["keys"]):
        fail(f"train: {n_cache} cache files for {len(first['keys'])} distinct target models")
    if ckpts != ["smoke_ep0001.pth", "smoke_ep0002.pth"]:
        fail(f"train: checkpoints {ckpts}")
    if loaded.get("epoch") != 2 or loaded.get("file") != "smoke_ep0002.pth" or not all(
            torch.equal(loaded["refiner"][k], v) for k, v in saved.items()) \
            or [st["epoch"] for st in resumed["stats"]] != [1, 2, 3] \
            or "Starting epoch 3" not in resumed["text"]:
        fail(f"train: the resumed run did not start at epoch 3 from the saved tensors "
             f"({loaded.get('file')}, {[st['epoch'] for st in resumed['stats']]})")
    ch = {L: c for L, c in resnet_out_channels("resnet101").items()
          if L in first["trainer"].model.cfg.refnet_layers}
    start = init_seg_network(ch, torch.Generator().manual_seed(1)).state_dict()
    trained = first["trainer"].model.refiner.state_dict()
    still = [n for n, _ in first["trainer"].model.refiner.named_parameters()
             if torch.equal(trained[n].cpu(), start[n].cpu())]
    if still:
        fail(f"train: parameters that never moved: {still}")
    # The warp runs only where a target model is solved, in the augmenter of a
    # cache miss. The first run starts with an empty cache; whether the resumed
    # run draws a sample that epochs 1-2 left out depends on the trainer's
    # unseeded generator, so there the warp is required exactly when it solved one.
    if first["solved"] == 0:
        fail("train (epochs_1_2): no target model was solved on an empty cache")
    for tag, run in runs.items():
        if any(run["launches"][k] == 0 for k in TRAIN_KERNELS if k != "warp_affine") \
                or (run["launches"]["warp_affine"] > 0) != (run["solved"] > 0) \
                or run["variants"]["pyrup"]["bf16"] or run["variants"]["conv3x3_cout1"]["bf16"] \
                or run["variants"]["pyrup_bwd"]["v4"] != run["launches"]["pyrup_bwd"] \
                or run["variants"]["conv3x3_cout1_dx"]["v2"] != \
                run["launches"]["conv3x3_cout1_dx"] \
                or run["variants"]["conv3x3_cout1_dw"]["v2"] != \
                run["launches"]["conv3x3_cout1_dw"]:
            fail(f"train ({tag}): launches {run['launches']}, instances {run['variants']}, "
                 f"target models solved {run['solved']}")
    small = phase_train_small()

    def per_step(run):
        # each step's target models (cache or cold start) and its train step
        secs = run["step_seconds"]
        return {"steps": len(secs), "seconds": secs,
                "samples_per_s": [16 / s for s in secs]}

    emit({"phase": "train", "arch": "resnet101", "size": [480, 854], "batch": 16,
          "num_aug": 15, "frames_per_sample": 3, "card": card,
          "samples_per_epoch": {"davis": 16, "ytvos": 2},
          "epochs": {tag: [st["epoch"] for st in run["stats"]] for tag, run in runs.items()},
          "stats": {tag: run["stats"] for tag, run in runs.items()},
          "steps": {tag: per_step(run) for tag, run in runs.items()},
          "distinct_target_models": {tag: len(run["keys"]) for tag, run in runs.items()},
          "target_models_solved": {tag: run["solved"] for tag, run in runs.items()},
          "cache_files_after_epoch_2": n_cache,
          "phase_seconds_synchronised": {tag: run["timer"] for tag, run in runs.items()},
          "launches": {tag: run["launches"] for tag, run in runs.items()},
          "instances": {tag: run["variants"] for tag, run in runs.items()},
          "wall_s": {tag: run["wall_s"] for tag, run in runs.items()},
          "max_memory_allocated": {tag: run["peak"] for tag, run in runs.items()},
          "checkpoints": ckpts, "resumed_from": loaded["file"], "params_moved": True,
          "small_step_cpu_vs_card": small})
    return {k: first["launches"][k] + resumed["launches"][k] for k in TRAIN_KERNELS}


# -- data-parallel training ---------------------------------------------------

# the dp_train phase's two fixed steps on its global batch of 16: all rows
# valid, then 2 real samples and 14 repeats, which leaves a second rank with
# padding only
DP_MASKS = (np.ones(16, np.float32), np.r_[np.ones(2), np.zeros(14)].astype(np.float32))


def dp_batch(davis):
    """The dp_train phase's global batch: the 16 samples of the DAVIS
    training tree of write_training_trees (one sequence, two objects, 8
    repeats) drawn with seeded generators; (images (3, 16, 480, 854, 3),
    labels (3, 16, 480, 854, 1), specs)."""
    import random
    from frtm_tpu_torch.data.training_datasets import DAVISTrainingDataset, SampleSpec
    dset = DAVISTrainingDataset(davis, epoch_repeats=8, sample_size=3,
                                rng=np.random.RandomState(0), py_rng=random.Random(0))
    items = [dset[i] for i in range(len(dset))]
    images = np.stack([np.stack([it[0][t] for it in items]) for t in range(3)])
    labels = np.stack([np.stack([it[1][t] for it in items]) for t in range(3)])
    return images, labels, SampleSpec.from_encoded([it[2] for it in items])


class GradRecorder:
    """make_sharded_train_step's optimizer interface; records the gradients
    it is given (after their all-reduce) and moves nothing."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self, lr):
        self.grads = [p.grad.detach().cpu().clone() for p in self.params]


class CollectiveClock:
    """While installed, every torch.distributed.all_reduce is timed with the
    card synchronised before and after it: (elements, seconds) per call."""

    def __enter__(self):
        import torch.distributed as dist
        self.calls, self.dist, self.all_reduce = [], dist, dist.all_reduce

        def timed(t, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.all_reduce(t, *args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((t.numel(), time.perf_counter() - t0))
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.all_reduce


def cpu_state(module):
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def median_logit(model, disc, images):
    """The median logit of the refiner over frame 1 of the batch's first two
    samples, with batch-statistics BatchNorm. A random refiner reads every
    pixel as background, so the accuracy, an IoU, is 0 on every rank and
    holds nothing; dp_child subtracts this from the head's bias, which
    leaves about half the pixels foreground and the accuracy nonzero."""
    from frtm_tpu_torch.models.discriminator import DiscParams
    from frtm_tpu_torch.models.seg_network import seg_network_apply
    from frtm_tpu_torch.runtime.trainer import classify_per_sample
    layers = model.cfg.refnet_layers
    frames = torch.as_tensor(images[1, :2]).cuda().permute(0, 3, 1, 2)
    with torch.no_grad():
        feats = model.backbone.extract_features(frames, output_layers=model._all_layers)
        scores = classify_per_sample(DiscParams(disc.project[:2], disc.filter[:2]),
                                     feats[model.disc_cfg.layer])
        logits, _ = seg_network_apply(model.refiner, scores, {L: feats[L] for L in layers},
                                      tuple(frames.shape[-2:]), layers=layers, train_bn=True)
    return float(logits.median())


def dp_child(mode, workdir):
    """One rank of the dp_train phase (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT in the environment): "nccl", a world of one
    rank over NCCL, or "gloo", two ranks on the one card (NCCL refuses two
    ranks a card). On its rows of the fixed global batch: one step whose
    gradients are recorded (its all-reduces timed), two AMSGrad steps
    (DP_MASKS; launches of the first counted, each timed); the one-rank
    world also runs the meshless trainer on the same batches, and solves the
    target models and centres the refiner's head (median_logit), which the
    two ranks then read. Then one epoch of
    `train.main` (--dp 1, or --multihost). Writes dp_{mode}{rank}.pt."""
    import os
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from frtm_tpu_torch import train
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.models.discriminator import DiscParams
    from frtm_tpu_torch.ops.kernels import LAUNCHES, VARIANTS, reset_launches
    from frtm_tpu_torch.parallel import (batch_sharded, init_distributed, make_mesh,
                                         make_sharded_train_step)
    from frtm_tpu_torch.runtime.trainer import AMSGrad, TModelCache, Trainer, TrainerModel
    workdir = Path(workdir)
    resolve_device("cuda")
    rank, size = init_distributed(backend="nccl" if mode == "nccl" else "gloo", device="cuda")
    mesh = make_mesh(size, device="cuda")
    cfg = train.train_config("resnet101")
    model = TrainerModel(cfg, *build_models("resnet101", cfg, "cuda"), TModelCache(None, False),
                         device="cuda")
    images, labels, specs = dp_batch(workdir / "DAVIS")
    if mode == "nccl":
        disc, _ = model.build_disc_batch(images[0], labels[0], specs)
        shift = -median_logit(model, disc, images)
        torch.save({"project": disc.project.cpu(), "filter": disc.filter.cpu(),
                    "head_shift": shift}, workdir / "dp_disc.pt")
    else:
        saved = torch.load(workdir / "dp_disc.pt")
        disc = DiscParams(saved["project"].cuda(), saved["filter"].cuda())
        shift = saved["head_shift"]
    with torch.no_grad():
        model.refiner.project.conv2.bias.add_(shift)
    sd0 = {k: v.clone() for k, v in model.refiner.state_dict().items()}
    rows = DiscParams(batch_sharded(mesh, disc.project), batch_sharded(mesh, disc.filter))
    im_rows, lb_rows = batch_sharded(mesh, images, 1), batch_sharded(mesh, labels, 1)
    masks = [batch_sharded(mesh, m) for m in DP_MASKS]
    step = make_sharded_train_step(model, mesh)
    out = {"rank": rank, "size": size, "rows": int(im_rows.shape[1])}

    def recorded(scale=1.0):
        model.refiner.load_state_dict(sd0)
        if scale != 1.0:
            with torch.no_grad():
                for p in model.refiner.parameters():
                    p.mul_(scale)
        rec = GradRecorder(model.refiner.parameters())
        with CollectiveClock() as clock:
            stats = step(rows, im_rows, lb_rows, masks[0], rec, 1.0)
        names = [n for n, _ in model.refiner.named_parameters()]
        return {"stats": stats, "grads": dict(zip(names, rec.grads)),
                "bn": {k: v for k, v in cpu_state(model.refiner).items()
                       if k.endswith(("running_mean", "running_var"))},
                "all_reduce_calls": clock.calls}

    recorded()                                  # first launches, cuDNN's choices
    out["recorded"] = recorded()
    if mode == "nccl":
        # the yardstick of the gradient bound: the one-rank step's own
        # movement when every refiner weight moves by one part in 1e6
        out["nudged"] = recorded(1 + 1e-6)
    out["n_params"] = sum(p.numel() for p in model.refiner.parameters())

    model.refiner.load_state_dict(sd0)
    opt = AMSGrad(model.refiner.parameters())
    torch.cuda.reset_peak_memory_stats()
    out["steps"], out["step_seconds"] = [], []
    for i, mask in enumerate(masks):
        if i == 0:
            reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["steps"].append(step(rows, im_rows, lb_rows, mask, opt, 1e-3))
        torch.cuda.synchronize()
        out["step_seconds"].append(time.perf_counter() - t0)
        if i == 0:
            out["launches_per_step"] = dict(LAUNCHES)
            out["variants_per_step"] = {k: dict(v) for k, v in VARIANTS.items()}
    out["peak_memory"] = torch.cuda.max_memory_allocated()
    out["stepped"] = cpu_state(model.refiner)
    if mode == "nccl":
        model.refiner.load_state_dict(sd0)
        opt = AMSGrad(model.refiner.parameters())
        out["meshless_steps"] = [model.train_step(disc, images, labels, m, opt, 1e-3)
                                 for m in DP_MASKS]
        out["meshless_stepped"] = cpu_state(model.refiner)
    del model, opt

    saves, save = [], Trainer.save_checkpoint

    def counted(self):
        saves.append(self.epoch)
        save(self)

    Trainer.save_checkpoint = counted
    argv = ["dp", "--ftext", "resnet101", "--dset", "all", "--dv2017", str(workdir / "DAVIS"),
            "--yt2018", str(workdir / "ytvos2018"), "--workspace", str(workdir / f"ws_{mode}"),
            "--dev", "cuda", "--batch-size", "16", "--max-epochs", "1"]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = train.main(argv + (["--dp", "1"] if mode == "nccl" else ["--multihost"]))
    torch.cuda.synchronize()
    out["epoch"] = {"wall_s": time.perf_counter() - t0, "saves": saves,
                    "launches": dict(LAUNCHES),
                    "variants": {k: dict(v) for k, v in VARIANTS.items()},
                    "refiner": cpu_state(trainer.model.refiner),
                    "mesh_size": trainer.mesh.size, "rank_env": os.environ.get("RANK")}
    torch.save(out, workdir / f"dp_{mode}{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def dp_ranks(mode, n, workdir):
    """Run n ranks of dp_child on this card; returns what each wrote."""
    import os
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(n), LOCAL_RANK="0")
    children = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-child", mode,
                                  str(workdir)], env=dict(env, RANK=str(r)),
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(n)]
    try:
        outs = [child.communicate(timeout=600)[0] for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    for rank, (child, text) in enumerate(zip(children, outs)):
        if child.returncode != 0:
            fail(f"dp_train ({mode}): rank {rank} of {n} exited with {child.returncode}:\n"
                 f"{text[-3000:]}")
    return [torch.load(workdir / f"dp_{mode}{r}.pt", weights_only=False) for r in range(n)]


def grad_gap_of_peak(got, want):
    """Worst gradient gap over the parameters, each a share of its peak; a
    conv bias before a batch-statistics BatchNorm (exact gradient 0) against
    the same conv's weight gradient."""
    gaps = {}
    for name, g in got.items():
        peak = want[name.replace("bias", "weight") if name.endswith("bblock.0.bias") else name]
        gaps[name] = float((g - want[name]).abs().max() / peak.abs().max())
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def rel_gap(got, want):
    """|got - want| / |want|; 0 where both are 0, infinite where only want
    is."""
    if want == 0:
        return 0.0 if got == 0 else math.inf
    return abs(got - want) / abs(want)


def all_reduce_seconds(calls, n_params):
    """The timed all-reduces of one step: the gradients' flat buffer, the
    BatchNorm statistics (per-channel sums with the count, squared
    deviations, and their gradients), and the small rest (valid count,
    loss and accuracy)."""
    grads = [t for n, t in calls if n == n_params]
    bn = [t for n, t in calls if 2 < n < n_params]
    rest = [t for n, t in calls if n <= 2]
    return {"gradients_s": sum(grads), "gradients_calls": len(grads),
            "batchnorm_s": sum(bn), "batchnorm_calls": len(bn), "other_s": sum(rest),
            "other_calls": len(rest)}


def phase_dp_train(card):
    """Data-parallel training (parallel/train_step.py, Trainer(mesh=), train
    --dp / --multihost) at full width: rn101, 480x854, train_config, three
    frames a sample, a global batch of 16, on trees made from the committed
    fixtures. A one-rank NCCL world against the meshless trainer, bit for
    bit, then one epoch of `train --dp 1`; two gloo ranks on this one card
    (8 rows each) against the one-rank step, their replicas equal after
    AMSGrad steps, then one epoch of `train --multihost` whose second batch
    leaves rank 1 only padding. Returns the epochs' kernel launches, summed
    over the three ranks."""
    with tempfile.TemporaryDirectory(prefix="frtm_dp_") as tmp:
        tmp = Path(tmp)
        write_training_trees(tmp)
        t0 = time.perf_counter()
        one, = dp_ranks("nccl", 1, tmp)
        wall_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = dp_ranks("gloo", 2, tmp)
        wall_two = time.perf_counter() - t0
        epoch_files = {mode: {
            "checkpoints": sorted(p.name for p in (tmp / f"ws_{mode}" / "checkpoints" / "dp").iterdir()),
            "stats": [json.loads(x) for x in open(tmp / f"ws_{mode}" / "logs" / "dp" / "stats.jsonl")]}
            for mode in ("nccl", "gloo")}

    ref = one["recorded"]
    yardstick, _ = grad_gap_of_peak(one["nudged"]["grads"], ref["grads"])
    grad_bound = 2 * yardstick + 1e-3
    bit_equal = one["steps"] == one["meshless_steps"] and all(
        torch.equal(v, one["meshless_stepped"][k]) for k, v in one["stepped"].items())
    checks = {"one_rank_bit_equal_to_meshless": bit_equal,
              "accuracy_nonzero": ref["stats"]["stats/accuracy"] > 0}
    ranks = []
    for r in two:
        got = r["recorded"]
        loss_gap = rel_gap(got["stats"]["stats/loss"], ref["stats"]["stats/loss"])
        acc_gap = rel_gap(got["stats"]["stats/accuracy"], ref["stats"]["stats/accuracy"])
        step_gaps = [rel_gap(a["stats/loss"], b["stats/loss"])
                     for a, b in zip(r["steps"], one["steps"])]
        grad_gap, worst = grad_gap_of_peak(got["grads"], ref["grads"])
        bn_gap = max(float((got["bn"][k] - v).abs().max() / v.abs().max())
                     for k, v in ref["bn"].items())
        ranks.append({"rank": r["rank"], "rows": r["rows"], "loss_rel_gap": loss_gap,
                      "accuracy_rel_gap": acc_gap, "amsgrad_step_loss_rel_gaps": step_gaps,
                      "grad_gap_of_peak": grad_gap, "grad_gap_worst": worst,
                      "running_stats_gap_of_peak": bn_gap, "steps": r["steps"],
                      "step_seconds": r["step_seconds"],
                      "all_reduce": all_reduce_seconds(got["all_reduce_calls"], r["n_params"]),
                      "peak_memory": r["peak_memory"], "launches_per_step": r["launches_per_step"],
                      "epoch_wall_s": r["epoch"]["wall_s"], "epoch_saves": r["epoch"]["saves"]})
    checks["two_ranks_within_bounds"] = all(
        x["loss_rel_gap"] <= 1e-4 and x["accuracy_rel_gap"] <= 1e-4
        and max(x["amsgrad_step_loss_rel_gaps"]) <= 1e-4 and x["grad_gap_of_peak"] <= grad_bound
        and x["running_stats_gap_of_peak"] <= 1e-5 for x in ranks)
    checks["replicas_bit_equal_after_amsgrad"] = all(
        torch.equal(v, two[1]["stepped"][k]) for k, v in two[0]["stepped"].items())
    checks["replicas_bit_equal_after_epoch"] = all(
        torch.equal(v, two[1]["epoch"]["refiner"][k]) for k, v in two[0]["epoch"]["refiner"].items())
    per_step = {"pyrup": 4, "conv3x3_cout1": 2, "pyrup_bwd": 4, "conv3x3_cout1_dx": 2,
                "conv3x3_cout1_dw": 2, "warp_affine": 0}
    checks["launches_per_rank_per_step"] = all(
        {k: r["launches_per_step"][k] for k in per_step} == per_step
        and r["variants_per_step"]["pyrup"]["bf16"] == 0
        and r["variants_per_step"]["conv3x3_cout1"]["bf16"] == 0
        and r["variants_per_step"]["pyrup_bwd"]["v4"] == 4
        and r["variants_per_step"]["conv3x3_cout1_dx"]["v2"] == 2
        and r["variants_per_step"]["conv3x3_cout1_dw"]["v2"] == 2 for r in [one] + two)
    stats = {mode: f["stats"] for mode, f in epoch_files.items()}
    checks["epochs_written_by_rank_0"] = (
        [r["epoch"]["saves"] for r in [one] + two] == [[1], [1], []]
        and all(f["checkpoints"] == ["dp_ep0001.pth"] for f in epoch_files.values())
        and all(len(st) == 1 and st[0]["epoch"] == 1 and np.isfinite(st[0]["stats/loss"])
                and np.isfinite(st[0]["stats/accuracy"]) for st in stats.values())
        and [r["epoch"]["mesh_size"] for r in [one] + two] == [1, 2, 2])
    checks["epoch_kernels_launched"] = all(
        all(r["epoch"]["launches"][k] > 0 for k in TRAIN_KERNELS if k != "warp_affine")
        and r["epoch"]["variants"]["pyrup"]["bf16"] == 0
        and r["epoch"]["variants"]["pyrup_bwd"]["v4"] == r["epoch"]["launches"]["pyrup_bwd"]
        for r in [one] + two) and one["epoch"]["launches"]["warp_affine"] > 0 \
        and sum(r["epoch"]["launches"]["warp_affine"] for r in two) > 0
    line = {"phase": "dp_train", "card": card, "arch": "resnet101", "size": [480, 854],
            "global_batch": 16, "frames_per_sample": 3,
            "label": "two ranks sharing one card over gloo: not a scaling figure; two cards over "
                     "NCCL are not measured",
            "checks": checks,
            "one_rank_nccl": {"steps": one["steps"], "step_seconds": one["step_seconds"],
                              "all_reduce": all_reduce_seconds(ref["all_reduce_calls"],
                                                               one["n_params"]),
                              "peak_memory": one["peak_memory"],
                              "launches_per_step": one["launches_per_step"],
                              "epoch_wall_s": one["epoch"]["wall_s"], "wall_s": wall_one},
            "two_ranks_gloo": ranks, "wall_s_two_ranks": wall_two,
            "gradient_yardstick_1e-6_nudge": yardstick, "epochs": stats,
            "tolerance": {"loss_rtol": 1e-4, "accuracy_rtol": 1e-4,
                          "grad_of_peak": grad_bound, "running_stats_of_peak": 1e-5}}
    emit(line)
    if not all(checks.values()):
        fail(f"dp_train: {[k for k, v in checks.items() if not v]}")
    return {k: sum(r["epoch"]["launches"][k] for r in [one] + two) for k in TRAIN_KERNELS}


# the synthetic phase's J floor: frtm_tpu's scripts/train_eval_synthetic.py
# --platform cpu at the same arguments read a mean J of 0.892 (PERF.md), less 0.1
SYNTHETIC_MIN_J = 0.792


def phase_synthetic(card):
    """scripts/torch_train_eval_synthetic.py --dev cuda at its defaults (rn18,
    8 epochs of 48 samples at 120x160, batch 8, 3 held-out sequences) with
    --compare-dtypes, in a process of its own; it fails under
    SYNTHETIC_MIN_J."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_train_eval_synthetic.py"),
                          "--dev", "cuda", "--compare-dtypes", "--min-j", str(SYNTHETIC_MIN_J)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    if res.returncode != 0:
        fail(f"synthetic: exit {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    summary = json.loads(res.stdout.splitlines()[-1])
    emit({"phase": "synthetic", "card": card, "wall_s": time.perf_counter() - t0, **summary})


def kernels_line(rows, launches, launches_fused, launches_eval, instances_eval,
                 launches_ytvos, instances_ytvos, launches_train, launches_device,
                 launches_sharded, launches_dp, ptxas):
    """The contract line: one entry per kernel instance at its main-path
    shape (pyrup stage 2 and the head conv at N = 1 in float32, where the
    host loop runs them, and at N = 16 in bfloat16, the eval path's window of
    8 frames and two objects; the full-frame background warp; the backward
    kernels at the training batch, N = 16, pyrup's at stage 2). `launches`
    sums the paths that run the instance, each counted from 0: the host loop,
    the float32 fused tracker and the two training runs for the float32
    instances, the unpipelined CLI runs (synthetic, DAVIS tree, DAVIS tree
    with the .npz model) and the YouTube-VOS CLI run for the bfloat16 ones,
    all of them for the one-map warp (its main row the host augmenter's
    mixed paste), and the device augment backend's timed passes for the
    batched warp (its main row a round's backgrounds, S = 19); the sharded
    phase's group of four (run_sequences, bfloat16) adds to the bfloat16
    instances and the one-map warp, and the dp_train phase's epochs (three
    ranks, float32) to the float32 instances, the backward kernels and the
    one-map warp.
    Each entry carries ptxas's readings of its source's kernel functions,
    each bfloat16 entry its time over the float32 instance's (bf16_over_f32),
    and each entry whose row names them the variant its launch took and the
    stripe rows and block warps it planned."""
    entries = [("pyrup", "pyrup", 1, False), ("conv3x3_cout1", "conv3x3_cout1", 0, False),
               ("warp_affine", "warp_affine", 0, True), ("pyrup_bf16", "pyrup", 5, True),
               ("conv3x3_cout1_bf16", "conv3x3_cout1", 2, True),
               ("pyrup_bwd", "pyrup_bwd", 1, False), ("conv3x3_cout1_dx", "conv3x3_cout1_dx", 0, False),
               ("conv3x3_cout1_dw", "conv3x3_cout1_dw", 0, False),
               ("warp_affine_batched", "warp_affine", 0, False)]
    out = []
    for name, kernel, main_row, in_eval in entries:
        replaces, source = KERNEL_INFO[name]
        r = rows[name][main_row]
        bf16 = name.endswith("_bf16")
        n_eval = (instances_eval[kernel]["bf16"] if bf16 else launches_eval[kernel]) \
            if in_eval else 0
        n_ytvos = (instances_ytvos[kernel]["bf16"] if bf16 else launches_ytvos[kernel]) \
            if in_eval else 0
        n_host, n_fused = (0, 0) if bf16 else (launches[kernel], launches_fused[kernel])
        n_train = 0 if bf16 else launches_train[kernel]
        n_dp = 0 if bf16 else launches_dp[kernel]
        # the sharded phase runs only bfloat16 decodes
        n_sharded = launches_sharded[kernel] if in_eval and (bf16 or kernel == "warp_affine") \
            else 0
        n_device = 0
        if name == "warp_affine_batched":
            n_host = n_fused = n_train = n_dp = 0
            n_device = launches_device[kernel]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": n_host + n_fused + n_eval + n_ytvos + n_train + n_device
                    + n_sharded + n_dp,
                    "launches_host_loop": n_host, "launches_fused": n_fused,
                    "launches_eval": n_eval, "launches_ytvos": n_ytvos,
                    "launches_train": n_train, "launches_device_augment": n_device,
                    "launches_sharded": n_sharded, "launches_dp_train": n_dp,
                    "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "event_ms": r["event_ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "shape": r["shape"], "tolerance": r["tolerance"],
                    **({"bf16_over_f32": r["bf16_over_f32"]} if bf16 else {}),
                    **{k: r[k] for k in ("variant", "rows", "warps", "role", "maps") if k in r},
                    "ptxas": ptxas.get(Path(source).stem),
                    "other_shapes": [o for i, o in enumerate(rows[name]) if i != main_row]})
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
    card = phase_probe()
    ptxas = phase_build()
    phase_native()
    rows = phase_kernels()
    cfg = eval_config("resnet101")
    seq = make_moving_square_sequence(n_frames=17, size=(480, 854), square=120, seed=0)
    tracker = Tracker(cfg, *build_models("resnet101", cfg, "cuda"), device="cuda", profile=True)
    phase_decode(tracker, seq)
    launches = phase_main(tracker, seq)
    launches_fused = phase_fused(cfg, tracker.backbone, tracker.refiner)
    phase_init_scaling(cfg, tracker.backbone, tracker.refiner, card)
    launches_sharded = phase_sharded(cfg, tracker.backbone, tracker.refiner, card)
    launches_device, _ = phase_device_augment(cfg, tracker.backbone, tracker.refiner, card)
    launches_eval, instances_eval = phase_eval(cfg, tracker.backbone, tracker.refiner)
    launches_ytvos, instances_ytvos = phase_ytvos(tracker.backbone, tracker.refiner)
    backbone = tracker.backbone
    del tracker
    phase_small()
    launches_train = phase_train(backbone, card)
    del backbone
    torch.cuda.empty_cache()
    launches_dp = phase_dp_train(card)
    phase_synthetic(card)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit(kernels_line(rows, launches, launches_fused, launches_eval, instances_eval,
                      launches_ytvos, instances_ytvos, launches_train, launches_device,
                      launches_sharded, launches_dp, ptxas))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-child"]:
        sharded_child(sys.argv[2])
    elif sys.argv[1:2] == ["--dp-child"]:
        dp_child(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--augment-round-child"]:
        augment_round_child()
    else:
        main()
