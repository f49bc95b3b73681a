#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port (frtm_tpu_torch) starts and
is right on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, each printing one JSON line:
  1. probe    — CUDA present, a real launch, card name and power limit;
  2. build    — the three CUDA kernels compiled from frtm_tpu_torch/ops/kernels/csrc
                (kernels 1 and 2 hold a float32 and a bfloat16 instance each);
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
                bound); the warp rows name the variant they took (staged or
                direct), and the phase gives the launch floor (a one-element
                zero_());
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
                48 warp launches, every decode launch the bfloat16 instance,
                every warp staged; no host wait in the scan; a re-run equal.
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
                16). Per sequence of every run: fps and host_cut_inpaint_s
                (the host's cut and Telea inpaint of every object, timed
                again after the run);
  7b. ytvos   — `frtm_tpu_torch.evaluate_ytvos.main` with --dev cuda --dtype
                bfloat16 on the committed YouTube-VOS-layout tree
                (tests/data/torch_fixtures/ytvos: 9 frames at 720x1280, object 2
                entering at frame 4), the legacy configuration and the
                deferred merge: one PNG per frame, each equal to what was
                tracked; frame 0 the ground truth of object 1, object 2's
                ground truth at its entry frame; a re-run equal byte for byte;
                launches 16 / 8 / 16 (the per-frame loop, 8 decodes of two
                lanes), all bf16 / staged; no host wait in the scan; a decode
                at 720x1280 in bf16, kernels against plain within one ulp.
                Printed: fps, phase seconds, peak memory;
  8. small    — a 6-frame 96x128 rn18 sequence through the port on the CPU
                (plain versions) and on the card (kernels); masks must agree,
                and each run must re-solve its filter twice.
Then a {"kernels": [...]} line (one entry per kernel instance) and, last, the
{"ok": true, "device": ...} line. Any failure exits non-zero before it.
Without CUDA, or without the frtm_tpu_torch package beside this file, the
script exits non-zero and prints no result.
"""
import contextlib
import io
import json
import math
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
    emit({"phase": "native", "build_seconds": build_s, "jpeg_backend": backend,
          "probe": native.PROBE, "telea": telea, "png_unfilter": png, "jpeg": jpegs,
          "functions": functions, "tolerance": {"telea": 0, "png": 0,
                                                "jpeg": "digest" if exact else "0.5 dB"}})


def bf16_ulp(peak):
    """The spacing of bfloat16 values at `peak` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(peak)) - 7)


def _compare(name, shape, kernel_fn, plain_fn, library_fn, nbytes, flops, tol):
    """tol: the largest max abs difference allowed, or "bf16_ulp" for one
    bfloat16 ulp at the plain version's peak."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name} {shape}: kernel gives {tuple(got.shape)} {got.dtype}, "
             f"plain {tuple(want.shape)} {want.dtype}")
    if tol == "bf16_ulp":
        tol = bf16_ulp(float(want.float().abs().max()))
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
    # N=16 (with two, the fused and eval phases' batch)
    stages, stages16 = [], []
    for shape in [(1, 32, 120, 214), (1, 16, 240, 428), (8, 32, 120, 214), (8, 16, 240, 428),
                  (16, 32, 120, 214), (16, 16, 240, 428)]:
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
    rows["pyrup"] = stages
    rows["pyrup_bf16"] = stages16

    # kernel 2: the head conv, (N, 16, 480, 854) -> 1, with bias, at N=1, 8, 16;
    # in bfloat16 within one ulp at the output's peak (a float32 sum that
    # differs in its last bits can round to the neighbouring value)
    w = (torch.rand(1, 16, 3, 3, generator=g) * 0.2 - 0.1).cuda()
    b = (torch.rand(1, generator=g) * 0.2 - 0.1).cuda()
    wh, bh = w.to(torch.bfloat16), b.to(torch.bfloat16)
    convs, convs16 = [], []
    for n in (1, 8, 16):
        x = torch.relu(torch.randn(n, 16, 480, 854, generator=g)).cuda()
        convs.append(_compare(
            "conv3x3_cout1", [n, 16, 480, 854], lambda x=x: conv3x3_cout1(x, w, b),
            lambda x=x: conv3x3_cout1_plain(x, w, b),
            lambda x=x: F.conv2d(x, w, b, padding=1),
            nbytes=4 * (x.numel() + n * 480 * 854 + w.numel() + 1),
            flops=2 * 9 * x.numel(), tol=5e-5))
        xh = x.to(torch.bfloat16)
        del x
        row = _compare(
            "conv3x3_cout1_bf16", [n, 16, 480, 854], lambda x=xh: conv3x3_cout1(x, wh, bh),
            lambda x=xh: conv3x3_cout1_plain(x, wh, bh),
            lambda x=xh: F.conv2d(x, wh, bh, padding=1),
            nbytes=2 * (xh.numel() + n * 480 * 854 + w.numel() + 1),
            flops=2 * 9 * xh.numel(), tol="bf16_ulp")
        row["values_equal_share"] = float(
            (conv3x3_cout1(xh, wh, bh) == conv3x3_cout1_plain(xh, wh, bh)).float().mean())
        convs16.append(row)
        del xh
    rows["conv3x3_cout1"] = convs
    rows["conv3x3_cout1_bf16"] = convs16

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
    resolves = [int(s.n_resolves) for _, s in fused.last_models]
    finite = all(bool(torch.isfinite(p.filter).all()) for p, _ in fused.last_models)

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
        if vr["direct"] or vr["staged"] != ln["warp_affine"] or ln["warp_affine"] != 8 * n_objects:
            fail(f"fused ({name}): expected 8 staged warps per object and no direct one, "
                 f"got {ln['warp_affine']} launches, {vr}")
    if resolves != [tracked // cfg.disc.train_skipping] * n_objects:
        fail(f"fused: filter re-solves {resolves}, expected one per window and object")
    return launches


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
                "warp_affine": 8 * n_objects * n_seqs}

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
            # the last run reads the committed DAVIS tree from disk: no dataset
            # object, the CLI's own DAVISDataset and JPEG decoder
            for tag, extra, dset in (("plain", [], dataset), ("pipelined", ["--pipeline"], dataset),
                                     ("davis", ["--davis", str(FIXTURES / "davis")], None)):
                BatchedSequenceTracker.run_tag = tag
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                text = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(text):
                    result = evaluate.main(argv + ["--output", str(tmp / tag)] + extra,
                                           dataset=dset)
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
                    or vr["warp_affine"] != {"staged": expected["warp_affine"], "direct": 0}:
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
    return ({k: runs["plain"]["launches"][k] + davis["launches"][k] for k in expected},
            {k: {i: runs["plain"]["variants"][k][i] + davis["variants"][k][i]
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
    expected = {"pyrup": 16, "conv3x3_cout1": 8, "warp_affine": 16}
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
                    or vr["conv3x3_cout1"]["f32"] or vr["warp_affine"]["direct"]:
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


def check_davis_run(run, recorded, out_root):
    """The CLI's run over the committed DAVIS tree: 9 PNGs equal to what was
    tracked, frame 0 the ground truth, both reports, launches of one window
    of two objects, all bf16 / staged."""
    from frtm_tpu_torch.data.image import imread
    anno = FIXTURES / "davis" / "Annotations" / "480p" / "blobs"
    if run["out_path"] != out_root.resolve() / "dv2017val-rn101_smoke" or list(recorded) != ["blobs"]:
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
    want = {"pyrup": 2, "conv3x3_cout1": 1, "warp_affine": 16}
    ln, vr = run["launches"], run["variants"]
    if {k: ln[k] for k in want} != want or vr["pyrup"]["bf16"] != 2 \
            or vr["conv3x3_cout1"]["bf16"] != 1 or vr["warp_affine"]["staged"] != 16:
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


def kernels_line(rows, launches, launches_fused, launches_eval, instances_eval,
                 launches_ytvos, instances_ytvos):
    """The contract line: one entry per kernel instance at its main-path
    shape (pyrup stage 2 and the head conv at N = 1 in float32, where the
    host loop runs them, and at N = 16 in bfloat16, the eval path's window of
    8 frames and two objects; the full-frame background warp). `launches`
    sums the paths that run the instance, each counted from 0: the host loop
    and the float32 fused tracker for the float32 instances, the unpipelined
    CLI runs (synthetic and DAVIS tree) and the YouTube-VOS CLI run for the
    bfloat16 ones, all of them for the warp."""
    entries = [("pyrup", "pyrup", 1, False), ("conv3x3_cout1", "conv3x3_cout1", 0, False),
               ("warp_affine", "warp_affine", 0, True), ("pyrup_bf16", "pyrup", 5, True),
               ("conv3x3_cout1_bf16", "conv3x3_cout1", 2, True)]
    out = []
    for name, kernel, main_row, in_eval in entries:
        replaces, source = KERNEL_INFO[kernel]
        r = rows[name][main_row]
        bf16 = name.endswith("_bf16")
        n_eval = (instances_eval[kernel]["bf16"] if bf16 else launches_eval[kernel]) * in_eval
        n_ytvos = (instances_ytvos[kernel]["bf16"] if bf16 else launches_ytvos[kernel]) * in_eval
        n_host, n_fused = (0, 0) if bf16 else (launches[kernel], launches_fused[kernel])
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": n_host + n_fused + n_eval + n_ytvos,
                    "launches_host_loop": n_host, "launches_fused": n_fused,
                    "launches_eval": n_eval, "launches_ytvos": n_ytvos,
                    "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "shape": r["shape"], "tolerance": r["tolerance"],
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
    phase_probe()
    phase_build()
    phase_native()
    rows = phase_kernels()
    cfg = eval_config("resnet101")
    seq = make_moving_square_sequence(n_frames=17, size=(480, 854), square=120, seed=0)
    tracker = Tracker(cfg, *build_models("resnet101", cfg, "cuda"), device="cuda", profile=True)
    phase_decode(tracker, seq)
    launches = phase_main(tracker, seq)
    launches_fused = phase_fused(cfg, tracker.backbone, tracker.refiner)
    launches_eval, instances_eval = phase_eval(cfg, tracker.backbone, tracker.refiner)
    launches_ytvos, instances_ytvos = phase_ytvos(tracker.backbone, tracker.refiner)
    del tracker
    phase_small()
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit(kernels_line(rows, launches, launches_fused, launches_eval, instances_eval,
                      launches_ytvos, instances_ytvos))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
