"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Elsewhere every test skips. Tolerances: pyrup and the warp repeat the plain
version's float operations in the same order without FMA contraction, so they
must agree bit for bit; the head conv sums 9 * Cin products with FMA in
another order, so it is held to 5e-5 absolute at unit-scale inputs. The
bfloat16 instances compute in float32 and round once, like their plain
versions: pyrup bit for bit again; the head conv within one bfloat16 ulp at
the output's peak (a float32 sum that differs in its last bits can round to
the neighbouring bfloat16 value).
"""
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from frtm_tpu_torch.device import resolve_device
from frtm_tpu_torch.ops.kernels import (LAUNCHES, VARIANTS, conv3x3_cout1,
                                        conv3x3_cout1_plain, pyr_up_bicubic,
                                        pyr_up_bicubic_plain, warp_affine)
from frtm_tpu_torch.ops.kernels.build import DTYPES
from frtm_tpu_torch.ops.warp import inverse_coefficients, warp_affine_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    resolve_device("cuda")
    return torch.Generator().manual_seed(0)


# the main path's two stages, N=8 (the fused tracker's decode window), and
# N=16 and 40 (that window with 2 and 5 objects);
# odd W (2W = 2 mod 4: 8-byte stores); 2W just below, at and above the
# 128-column tile (W = 63, 64, 65, 66); H below and just above the
# 32-row-pair tile (H = 5, 32, 33); a single pixel
@pytest.mark.parametrize("shape", [(1, 32, 120, 214), (1, 16, 240, 428), (8, 32, 120, 214),
                                   (16, 32, 120, 214), (16, 16, 240, 428),
                                   (40, 32, 120, 214), (40, 16, 240, 428), (2, 3, 7, 5), (1, 1, 1, 1), (1, 2, 9, 131),
                                   (1, 3, 5, 63), (1, 3, 32, 64), (1, 3, 17, 65),
                                   (2, 2, 33, 66)])
@pytest.mark.parametrize("instance", ["f32", "bf16"])
def test_pyrup_kernel_is_bit_exact(gen, shape, instance):
    """In bfloat16, W even takes 4-byte pair copies and 8-byte stores, W odd
    (5, 131, 63, 65) element copies and 4-byte stores."""
    x = torch.randn(shape, generator=gen).cuda().to(DTYPES[instance])
    before, vbefore = LAUNCHES["pyrup"], dict(VARIANTS["pyrup"])
    got = pyr_up_bicubic(x)
    assert LAUNCHES["pyrup"] == before + 1
    assert VARIANTS["pyrup"][instance] == vbefore[instance] + 1
    assert got.dtype == x.dtype
    assert torch.equal(got, pyr_up_bicubic_plain(x))
    if instance == "bf16":      # and the plain version is the float32 one, rounded once
        assert torch.equal(got, pyr_up_bicubic_plain(x.float()).to(torch.bfloat16))


# the head conv at N=1, 8, 16 and 40 (the batch is the grid's z extent,
# limit 65535); Cin 1, 3, 16 and 64; rows only 4-byte
# aligned (W = 129, 127: 4-byte copies); H below (4, 5, 7, 9) and just above
# (17) the 16-row tile
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(1, 16, 480, 854), (8, 16, 480, 854), (16, 16, 480, 854),
                                   (40, 16, 480, 854), (2, 3, 5, 129),
                                   (1, 64, 17, 33), (1, 1, 9, 130), (3, 1, 4, 7),
                                   (1, 3, 7, 127)])
@pytest.mark.parametrize("instance", ["f32", "bf16"])
def test_conv3x3_cout1_kernel_matches_plain(gen, shape, bias, instance):
    dtype = DTYPES[instance]
    x = torch.randn(shape, generator=gen).cuda().to(dtype)
    w = (torch.rand(1, shape[1], 3, 3, generator=gen) * 0.2 - 0.1).cuda().to(dtype)
    b = torch.randn(1, generator=gen).cuda().to(dtype) if bias else None
    vbefore = dict(VARIANTS["conv3x3_cout1"])
    got = conv3x3_cout1(x, w, b)
    assert VARIANTS["conv3x3_cout1"][instance] == vbefore[instance] + 1
    want = conv3x3_cout1_plain(x, w, b)
    assert got.dtype == want.dtype == dtype
    if instance == "f32":
        torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
        return
    peak = float(want.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(peak)) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp
    # nearly every value is the same bfloat16 number
    assert float((got != want).float().mean()) < 0.02


_MATS = {
    "rot": np.asarray([[0.94, -0.34, 3.2], [0.34, 0.94, -2.1], [0, 0, 1]], np.float32),
    "scale2x3": np.asarray([[1.3, 0.0, -1.5], [0.0, 0.8, 2.0]], np.float32),
    "projective": np.asarray([[1.0, 0.1, 2.0], [0.05, 0.9, -1.0], [1e-3, -2e-3, 1.0]],
                             np.float32),
    "off_frame": np.asarray([[1.0, 0.0, 500.0], [0.0, 1.0, 500.0], [0, 0, 1]], np.float32),
}


def _warp_checked(src, M, size, mode, variant):
    """The kernel's warp, checked to launch once, by `variant`, and to equal
    the plain version bit for bit."""
    want = warp_affine_plain(src, inverse_coefficients(M), size, mode)
    before, vbefore = LAUNCHES["warp_affine"], dict(VARIANTS["warp_affine"])
    got = warp_affine(src, M, size, mode)
    assert LAUNCHES["warp_affine"] == before + 1
    assert VARIANTS["warp_affine"][variant] == vbefore[variant] + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("mat", sorted(_MATS))
def test_warp_kernel_is_bit_exact(gen, mode, mat):
    src = (torch.rand(4, 48, 85, generator=gen) * 255).cuda()
    _warp_checked(src, _MATS[mat], (40, 90), mode,
                  "direct" if mat == "projective" else "staged")


def _affine(angle, scale, flip=False, skew=0.0, to=(120.0, 100.0), frm=(160.0, 120.0)):
    """The augmenter's map: the source point `frm` to the output point `to`,
    with mirror, scale, rotation (degrees) and skew about it."""
    a = np.deg2rad(angle)
    return (np.array([[1, 0, to[0]], [0, 1, to[1]], [0, 0, 1]])
            @ np.array([[1, skew, 0], [skew, 1, 0], [0, 0, 1]])
            @ np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]])
            @ np.diag([-scale if flip else scale, scale, 1.0])
            @ np.array([[1, 0, -frm[0]], [0, 1, -frm[1]], [0, 0, 1]]))


# (channels, map, output size, variant) on a 240x320 source: inverse step 2
# at 45 degrees (the augmenter's worst footprint), mirrors and skew, output
# boxes of one pixel, 3x5 and odd widths (ragged tiles), C = 1, 2, 3, 4,
# 480x854 outputs rotated (most tiles border) and axis-aligned (the eval
# background's map), footprints partly and fully off the frame, and a
# shrink by 5, or 40 channels, whose boxes exceed the shared-memory budget
_WARPS = {
    "step2_45deg": (4, _affine(45, 0.5), (200, 240), "staged"),
    "step2_skew_flip": (4, _affine(-45, 0.5, flip=True, skew=0.1), (200, 240), "staged"),
    "flip": (3, _affine(20, 1.3, flip=True), (200, 240), "staged"),
    "skew": (3, _affine(-30, 0.7, skew=0.1), (131, 97), "staged"),
    "one_pixel": (4, _affine(10, 1.5), (1, 1), "staged"),
    "3x5": (3, _affine(30, 2.0), (3, 5), "staged"),
    "odd_width": (1, _affine(-10, 1.0), (37, 33), "staged"),
    "c1": (1, _affine(5, 1.2), (480, 854), "staged"),
    "axis_aligned": (3, _affine(0, 1.2), (480, 854), "staged"),
    "c2": (2, _affine(-60, 1.7), (120, 150), "staged"),
    "partly_off": (3, _affine(60, 0.7, to=(50.0, 50.0), frm=(10.0, 10.0)), (100, 130),
                   "staged"),
    "fully_off": (4, _affine(0, 1.0, to=(0.0, 0.0), frm=(900.0, 900.0)), (64, 96), "staged"),
    "over_budget": (3, _affine(45, 0.2), (200, 240), "direct"),
    "channels_over_budget": (40, _affine(10, 1.0), (64, 96), "direct"),
}


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("case", sorted(_WARPS))
def test_warp_variants_are_bit_exact(gen, mode, case):
    c, M, size, variant = _WARPS[case]
    src = (torch.rand(c, 240, 320, generator=gen) * 255).cuda()
    _warp_checked(src, M, size, mode, variant)


_OVER_PLAN = """
import ctypes, torch
from frtm_tpu_torch.ops.kernels import build
from frtm_tpu_torch.ops.kernels.warp_affine import _ARGTYPES
src = torch.rand(1, 64, 64, device="cuda")
out = torch.empty(1, 32, 32, device="cuda")
fn = build.library("warp_affine").frtm_warp_affine_staged_f32
fn.argtypes = _ARGTYPES + [ctypes.c_int] * 3 + [ctypes.c_void_p]
identity = (ctypes.c_float * 9)(1, 0, 0, 0, 1, 0, 0, 0, 1)
# a planned box of 2x2 against the identity's ~20x38 tile boxes
assert fn(src.data_ptr(), out.data_ptr(), 1, 64, 64, 32, 32, identity, 2, 2, 2, 0, None) == 0
try:
    torch.cuda.synchronize()
    print("no error")
except RuntimeError as e:
    print("launch failed:", e)
"""


def test_staged_warp_fails_on_a_box_over_its_plan(gen):
    """A tile whose source box exceeds the planned box stops the staged
    launch with an error; nothing stands in for it. In a child process,
    since the error leaves that process's CUDA context unusable."""
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", _OVER_PLAN], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert "launch failed" in r.stdout, r.stdout + r.stderr


def test_warp_kernel_keeps_uint8_labels(gen):
    lbl = (torch.rand(1, 48, 85, generator=gen) > 0.5).to(torch.uint8).cuda()
    got = warp_affine(lbl, _MATS["rot"], (30, 40), "nearest")
    assert got.dtype == torch.uint8
    assert torch.equal(got.cpu(), warp_affine(lbl.cpu(), _MATS["rot"], (30, 40), "nearest"))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(1, 4, 8, 10, generator=gen).cuda()
    with pytest.raises(TypeError):
        pyr_up_bicubic(x.double())
    with pytest.raises(ValueError):
        pyr_up_bicubic(x.transpose(2, 3))
    with pytest.raises(ValueError):
        conv3x3_cout1(x, torch.zeros(1, 3, 3, 3, device="cuda"))
    with pytest.raises(TypeError):      # one element type for input, weight and bias
        conv3x3_cout1(x.bfloat16(), torch.zeros(1, 4, 3, 3, device="cuda"))
    with pytest.raises(TypeError):
        conv3x3_cout1(x.half(), torch.zeros(1, 4, 3, 3, device="cuda").half())
    with pytest.raises(RuntimeError):   # weights and halos beyond 48 KB of shared memory
        conv3x3_cout1(torch.zeros(1, 926, 4, 4, device="cuda"),
                      torch.zeros(1, 926, 3, 3, device="cuda"))
    with pytest.raises(ValueError):
        warp_affine(x[0], np.eye(2), (8, 10))


def _small_fused_world(compute_dtype="float32"):
    from dataclasses import replace
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.models.resnet import resnet_out_channels
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network
    cfg = eval_config("resnet18", fast=True, num_aug=3, compute_dtype=compute_dtype)
    cfg = replace(cfg, disc=replace(cfg.disc, init_iters=(3, 5), update_iters=(3,),
                                    memory_size=8, c_channels=16, train_skipping=2))
    ch = {L: c for L, c in resnet_out_channels("resnet18").items() if L in cfg.refnet_layers}
    tracker = BatchedSequenceTracker(
        cfg, init_resnet("resnet18", torch.Generator().manual_seed(1)),
        init_seg_network(ch, torch.Generator().manual_seed(2)))
    assert tracker.device.type == "cuda"
    return tracker


@pytest.mark.parametrize("instance", ["f32", "bf16"])
def test_fused_tracker_decodes_through_the_kernels(gen, monkeypatch, instance):
    """The fused tracker's window decode on the card launches kernels 1 and 2
    (2 pyrups and 1 head conv per decode call) in the instance of its compute
    type and in no other, never their plain versions."""
    from importlib import import_module
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.ops.kernels import reset_launches

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    tracker = _small_fused_world({"f32": "float32", "bf16": "bfloat16"}[instance])
    seq = make_moving_square_sequence(n_frames=6, size=(96, 128), square=24, n_objects=2,
                                      seed=2)
    # the wrappers' own modules (the package re-exports the functions under
    # the same names)
    monkeypatch.setattr(import_module("frtm_tpu_torch.ops.kernels.pyrup"),
                        "pyr_up_bicubic_plain", refuse)
    monkeypatch.setattr(import_module("frtm_tpu_torch.ops.kernels.conv3x3_cout1"),
                        "conv3x3_cout1_plain", refuse)
    reset_launches()
    outputs, _ = tracker.run_sequence(seq)
    windows = 3                                  # 5 tracked frames, windows of 2
    other = "bf16" if instance == "f32" else "f32"
    assert LAUNCHES["pyrup"] == 2 * windows and LAUNCHES["conv3x3_cout1"] == windows
    assert VARIANTS["pyrup"] == {instance: 2 * windows, other: 0}
    assert VARIANTS["conv3x3_cout1"] == {instance: windows, other: 0}
    assert VARIANTS["warp_affine"]["direct"] == 0 and LAUNCHES["warp_affine"] > 0
    assert len(outputs) == 6 and all(o.shape == (96, 128) for o in outputs)
    if instance == "bf16":
        assert tracker.last_feats_dtype == torch.bfloat16


class _Dataset:
    """The least of a dataset that run_dataset reads."""
    name = "synthetic"

    def __init__(self, sequences):
        self.sequences = sequences

    def __iter__(self):
        return iter(self.sequences)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pipelined_run_dataset_gives_the_same_labels(gen, tmp_path, compute_dtype):
    """run_dataset(pipeline=True) prepares sequence i + 1 on a second thread
    and a second CUDA stream while sequence i tracks; the tracker's stream
    waits on the preparation's event before it reads. A race would show as
    labels that differ from the unpipelined run's: the PNGs must be equal
    byte for byte, over several passes."""
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    tracker = _small_fused_world(compute_dtype)
    seqs = [make_moving_square_sequence(n_frames=9, size=(96, 128), square=24,
                                        n_objects=1 + i % 2, seed=10 + i, name=f"s{i}")
            for i in range(6)]
    tracker.run_dataset(_Dataset(seqs), tmp_path / "plain")
    for attempt in range(3):
        out = tmp_path / f"piped{attempt}"
        tracker.run_dataset(_Dataset(seqs), out, pipeline=True)
        for seq in seqs:
            for name in seq.frame_names:
                assert ((out / seq.name / f"{name}.png").read_bytes()
                        == (tmp_path / "plain" / seq.name / f"{name}.png").read_bytes()), \
                    (attempt, seq.name, name)


def test_count_host_syncs_sees_reads_and_blocking_uploads(gen):
    """The counter behind the fused tracker's `host_syncs`: a read and a
    blocking upload count, launches and views do not."""
    from frtm_tpu_torch.utils.profiling import count_host_syncs
    x = torch.ones(8, device="cuda")
    with count_host_syncs("cuda") as syncs:
        y = (x * 2).sum()
        z = y[None].expand(3)
    assert syncs.count == 0
    with count_host_syncs("cuda") as syncs:
        float(y)
        torch.arange(4.0).to("cuda")
    assert syncs.count == 2, syncs.where
    assert torch.cuda.get_sync_debug_mode() == 0 and z.shape == (3,)


def test_jpeg_backend_decodes_the_fixtures(gen):
    """The host library's JPEG backend on the card's machine decodes the
    committed fixtures (tests/data/torch_fixtures) to the manifest's sha256
    of PIL's decode where it is libjpeg-turbo; another decoder (IJG libjpeg,
    nvJPEG) upsamples chroma otherwise and must come within 0.5 dB of the
    manifest's PSNR against the source frame, rebuilt with numpy."""
    import hashlib
    import importlib.util
    import json
    from frtm_tpu_torch.data.image import imread
    from frtm_tpu_torch.utils import native
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "make_torch_jpeg_fixtures", root / "scripts" / "make_torch_jpeg_fixtures.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fixtures = root / "tests" / "data" / "torch_fixtures"
    manifest = json.loads((fixtures / "manifest.json").read_text())
    native.library()
    exact = native.JPEG_BACKEND.startswith("libjpeg-turbo")
    for name, entry in manifest["jpeg"].items():
        got = imread(fixtures / name)
        assert list(got.shape) == entry["shape"], name
        if exact:
            assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"], name
        assert abs(script.psnr(got, script.source_of(name)) - entry["psnr_db"]) <= 0.5, name
    (name, entry), = manifest["png"].items()
    assert hashlib.sha256(imread(fixtures / name).tobytes()).hexdigest() == entry["sha256"]


def _legacy_mode_readings(mode, seed=2, entry=3, layers=("layer5", "layer4"), score_gain=1.0):
    """The fused tracker's deferred merge at 480x854, two objects, with the
    target-model layers `layers` ('disc_layers') or the legacy 'thresh' update, run
    on the card and on the CPU (plain versions, no cuDNN), and on the CPU
    again with the input features moved by 1e-6 (the stem convolution
    scaled by 1 + 1e-6), the yardstick the CPU tests use for frtm_tpu.

    The random refiner's score inputs (the last channels of each TSE's first
    transform) are scaled by `score_gain` (1 in the test; larger gains made
    the fixture less well conditioned); the head is then scaled so that the
    CPU's frame-1 logits have median 0 and spread 2. Object 2 enters at frame
    `entry` (None: both at frame 0) of the sequence drawn from `seed`.
    Returns the soft volumes' largest gap and the labels' largest per-frame
    mismatch, card against CPU and nudged CPU against CPU, and the card's
    tracker."""
    import copy
    from dataclasses import replace
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.models.resnet import resnet_out_channels
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker, merge_volume
    from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network

    cfg = eval_config("resnet18", fast=True, num_aug=3)
    cfg = replace(cfg, disc=replace(cfg.disc, init_iters=(3, 5), update_iters=(3,),
                                    memory_size=8, c_channels=16, train_skipping=2))
    if mode == "disc_layers":
        cfg = replace(cfg, disc_layers=tuple(layers))
    else:
        cfg = replace(cfg, disc=replace(cfg.disc, update_method="thresh",
                                        cg_forgetting_rate=75))
    ch = {L: c for L, c in resnet_out_channels("resnet18").items() if L in cfg.refnet_layers}
    n_scores = max(1, len(cfg.disc_layers))
    backbone = init_resnet("resnet18", torch.Generator().manual_seed(1), "cpu")
    refiner = init_seg_network(ch, torch.Generator().manual_seed(2), in_channels=n_scores,
                               device="cpu")
    with torch.no_grad():
        for tse in refiner.TSE.values():
            tse.transform[0].weight[:, -n_scores:] *= score_gain

    def sequence(n_frames):
        seq = make_moving_square_sequence(n_frames=n_frames, size=(480, 854), square=120,
                                          n_objects=2, seed=seed)
        if entry is not None and n_frames > entry:
            seq.start_frames = {"00000": [1], f"{entry:05d}": [2]}
        return seq

    def run(dev, n_frames=5, bb=backbone):
        tracker = BatchedSequenceTracker(cfg, copy.deepcopy(bb), copy.deepcopy(refiner),
                                         merge_mode="deferred", device=dev)
        vol, _ = tracker.run_sequence(sequence(n_frames), soft=True)
        return vol, tracker

    vol, _ = run("cpu", n_frames=2)
    y = np.clip(vol[1].astype(np.float64), 1e-12, 1 - 1e-12)
    logits = np.log(y) - np.log1p(-y)
    with torch.no_grad():
        conv2 = refiner.project.conv2
        conv2.weight.mul_(2.0 / float(logits.std()))
        conv2.bias.sub_(float(np.median(logits))).mul_(2.0 / float(logits.std()))
    nudged = copy.deepcopy(backbone)
    with torch.no_grad():
        nudged.conv1.weight.mul_(1 + 1e-6)
    (cpu, _), (card, tracker) = run("cpu"), run("cuda")
    cpu_nudged, _ = run("cpu", bb=nudged)
    assert np.isfinite(card).all() and card.shape == (5, 2, 480, 854)
    lut = torch.tensor([0, 1, 2], dtype=torch.int32)
    labels = [merge_volume(torch.from_numpy(v), lut).numpy() for v in (cpu, card, cpu_nudged)]

    def gaps(other, other_labels):
        return (float(np.abs(cpu - other).max()),
                max(float(np.mean(a != b)) for a, b in zip(labels[0], other_labels)))
    (soft, mismatch), (soft_self, mismatch_self) = gaps(card, labels[1]), gaps(cpu_nudged,
                                                                                 labels[2])
    return {"soft": soft, "mismatch": mismatch, "soft_nudged": soft_self,
            "mismatch_nudged": mismatch_self}, tracker


@pytest.mark.parametrize("mode", ["disc_layers", "thresh"])
def test_fused_tracker_legacy_modes_match_the_cpu_path(gen, mode):
    """The fused tracker's deferred merge at 480x854 with two target-model
    layers (layer5 and layer4), and with the legacy 'thresh' update, object 2
    entering at frame 3, on the card against the same run on the CPU (plain
    versions, no cuDNN): soft volumes within 1e-2 and labels under 0.5 % of
    a frame, as the smoke's CPU-against-card run is held. The fixture must
    be well conditioned for that bound to mean anything: a 1e-6 nudge of the
    CPU run's features must move its labels on under 0.25 % of a frame.
    (With layer3's target model, random weights make the init solve
    ill-conditioned: the nudge alone moved labels by 1-2.6 %,
    scripts/torch_legacy_mode_conditioning.py.)"""
    readings, tracker = _legacy_mode_readings(mode)
    print(mode, readings)
    assert readings["mismatch_nudged"] < 2.5e-3, readings
    assert readings["soft"] <= 1e-2 and readings["mismatch"] < 5e-3, readings
    for k, (params, state) in enumerate(tracker.last_models):
        if mode == "disc_layers":
            assert set(params) == set(state) == {"layer4", "layer5"}
            assert [int(state[L].n_resolves) for L in ("layer4", "layer5")] == \
                ([2, 2] if k == 0 else [0, 0])
        else:
            assert int(state.n_resolves) == (2 if k == 0 else 0)
