"""The slice as a whole: frtm_tpu's BatchedSequenceTracker and the port's on
the CPU, on the same synthetic sequences, with the same backbone, refiner
and target-model starting weights (converted) and the JAX augmenter's
batches fed to both, so the comparison isolates the tracker.

The weights are made so that the masks are worth comparing. A random
refiner hardly reads its score input (its logits span 0.01 and sit on one
side of 0), so every object would get the same constant mask. Here the
score channel's weights of each TSE are multiplied by SCORE_GAIN, after
which an object's logits follow its own target model, and the head is
scaled so that frame 1's logits have median 0 and standard deviation
HEAD_SPREAD: every object holds part of the frame, memory inserts pass the
10-pixel gate, and train_skipping=2 puts re-solves inside the 6-7 frames.

Tolerances, with the measured values: labels differ on under 0.5 % of the
pixels of a frame (the bound tests/test_sequence_tracker.py holds the two
JAX engines to); measured at most 0.033 %, one pixel of 3072. The deferred
soft volume within 1e-3; measured 9.63e-5 at frame 3 (3.3e-5, 2.7e-5,
9.6e-5, 7.9e-5, 4.3e-5 over frames 1-5), the same to the last bit in every
run on one machine. That difference starts in the init's GN-CG solve, which
is ill-conditioned at this size (scores differ by 2.3e-5 after it; see
test_torch_tracker.py), and grows with the head's gain: a smaller
HEAD_SPREAD would shrink it, but under 0.5 the two objects' odds tie with
the background's and one object vanishes. The yardstick for the bound is
frtm_tpu's own sensitivity: when its input features move by 1e-6 (relative;
the stem convolution scaled by 1 + 1e-6) its own volume moves by 3.1e-3 at
frame 3. 1e-3 is a third of that and ten times the measured gap, so another
machine's last bits cannot eat the margin, while a fault of the tracker
(a lane's batch swapped moves the volume by 0.19) stays far above it.

frtm_tpu's fused tracker runs here behind FreshBatches (test_torch_tracker.py):
on the CPU backend its reused augment buffers may be aliased by `jnp.asarray`,
and a two-object run then depends on the alignment `np.empty` happened to
return. `test_jax_volume_ignores_augment_buffer_alignment` holds that.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.config import eval_config as jax_eval_config
from frtm_tpu.data.synthetic import make_moving_square_sequence
from frtm_tpu.models import init_resnet, init_seg_network, resnet_out_channels
from frtm_tpu.runtime.sequence_tracker import BatchedSequenceTracker as JaxFused
from frtm_tpu_torch.config import eval_config
from frtm_tpu_torch.models.discriminator import classify_objects, project_all
from frtm_tpu_torch.models.resnet import ResNet
from frtm_tpu_torch.models.seg_network import SegNetwork
from frtm_tpu_torch.runtime import sequence_tracker
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from frtm_tpu_torch.utils import profiling
from frtm_tpu_torch.utils.convert import (disc_objects_from_jax, disc_params_from_jax,
                                          resnet_from_jax, seg_network_from_jax)
from test_torch_tracker import SMALL, FreshBatches, JaxAugmenterShim

# The suite runs under xdist with about as many workers as the machine has
# cores. PyTorch would give every worker a thread per core, and at these
# sizes the workers then spend their time waiting for each other: this
# module's tests took 30-77 s each that way and 1-5 s with two threads.
torch.set_num_threads(2)

ARCH = "resnet18"
SIZE, SQUARE = (48, 64), 14
SCORE_GAIN = 300.0
HEAD_SPREAD = 0.5


def _small(cfg):
    return replace(cfg, disc=replace(cfg.disc, **SMALL))


def _sequence(n_frames, n_objects, starts=None, seed=2):
    seq = make_moving_square_sequence(n_frames=n_frames, size=SIZE, square=SQUARE,
                                      n_objects=n_objects, seed=seed)
    if starts:
        seq.start_frames = starts
    return seq


class World:
    """Weights and trackers shared by the tests of this module: each JAX
    tracker compiles its programs once per shape."""

    def __init__(self):
        self.jcfg = _small(jax_eval_config(ARCH, fast=True, num_aug=3))
        self.tcfg = _small(eval_config(ARCH, fast=True, num_aug=3))
        self.backbone = init_resnet(jax.random.PRNGKey(1), ARCH)
        self.ch = {L: c for L, c in resnet_out_channels(ARCH).items()
                   if L in self.jcfg.refnet_layers}
        refiner = init_seg_network(jax.random.PRNGKey(2), self.ch)
        for p in refiner["tse"].values():
            w = np.array(p["transform1"]["w"])
            w[:, :, -1, :] *= SCORE_GAIN          # HWIO: the score is the last input
            p["transform1"] = dict(p["transform1"], w=jnp.asarray(w))
        self.refiner = refiner
        self.jax_trackers = {}
        p0 = self.jax("online")._disc_params0[self.jcfg.disc.layer]
        self.p0 = disc_params_from_jax(np.asarray(p0.project), np.asarray(p0.filter))
        # scale the head from the port's own frame-1 logits (two objects)
        vol, _ = self.port("deferred").run_sequence(_sequence(2, 2), soft=True)
        y = np.clip(vol[1].astype(np.float64), 1e-12, 1 - 1e-12)
        logits = np.log(y) - np.log1p(-y)
        scale = HEAD_SPREAD / float(logits.std())
        conv2 = refiner["up"]["conv2"]
        refiner["up"]["conv2"] = dict(conv2, w=conv2["w"] * scale,
                                      b=(conv2["b"] - float(np.median(logits))) * scale)
        self.jax_trackers = {}

    def jax(self, merge_mode, compute_dtype="float32"):
        key = (merge_mode, compute_dtype)
        if key not in self.jax_trackers:
            tracker = JaxFused(replace(self.jcfg, compute_dtype=compute_dtype), self.backbone,
                               self.refiner, extract_chunk=4, scan_bucket=8,
                               merge_mode=merge_mode)
            # its own augmenter hands out reused buffers, which the CPU
            # backend may alias (FreshBatches' docstring)
            tracker.augmenter = FreshBatches(tracker.augmenter)
            self.jax_trackers[key] = tracker
        return self.jax_trackers[key]

    def port_models(self):
        tb = ResNet(ARCH)
        tb.load_state_dict(resnet_from_jax(jax.tree.map(np.asarray, self.backbone)))
        tr = SegNetwork(self.ch)
        tr.load_state_dict(seg_network_from_jax(jax.tree.map(np.asarray, self.refiner)))
        return tb, tr

    def port(self, merge_mode="online", compute_dtype="float32", **kw):
        return BatchedSequenceTracker(replace(self.tcfg, compute_dtype=compute_dtype),
                                      *self.port_models(), extract_chunk=4,
                                      merge_mode=merge_mode, device="cpu", disc_params0=self.p0,
                                      augmenter=JaxAugmenterShim(self.jcfg.aug_params), **kw)


@pytest.fixture(scope="module")
def world():
    return World()


def _assert_labels_close(got, want, n_objects, bound=0.005):
    assert len(got) == len(want)
    worst = max(float(np.mean(a != b)) for a, b in zip(got, want))
    assert worst < bound, [float(np.mean(a != b)) for a, b in zip(got, want)]
    # the comparison is not of constant masks: every object holds pixels in
    # the tracked frames, and so does the background
    for lb in want[1:]:
        counts = [int((lb == i).sum()) for i in range(n_objects + 1)]
        assert min(counts) >= 10, counts
    return worst


@pytest.mark.parametrize("n_objects", [1, 2])
def test_fused_tracker_matches_jax(world, n_objects):
    """Online merge, all objects from frame 0: the windowed loop. Measured
    label differences: 0 for one object and for two."""
    seq = _sequence(6, n_objects)
    want, _ = world.jax("online").run_sequence(seq)
    port = world.port()
    got, fps = port.run_sequence(seq)
    assert fps > 0 and all(o.dtype == np.uint8 and o.shape == SIZE for o in got)
    _assert_labels_close(got, want, n_objects)
    np.testing.assert_array_equal(got[0], seq.labels[0][..., 0])
    # frames 2 and 4 re-solved every object's filter
    _, state = port.last_models
    assert state.n_resolves.tolist() == [2] * n_objects
    assert state.frame_num == [5] * n_objects
    assert set(port.last_phase_stats) == {"extract", "augment", "aug_upload", "disc_init", "scan"}


@pytest.mark.parametrize("start", [2, 3])
def test_mid_sequence_entry_matches_jax(world, start):
    """Object 2 enters at frame `start`: 2 is a window boundary (the windowed
    loop), 3 is not (the per-frame loop, each object on its own re-solve
    cadence). Measured label differences: 0 and 0.033 % (one pixel)."""
    seq = _sequence(7, 2, starts={"00000": [1], "%05d" % start: [2]}, seed=4)
    want, _ = world.jax("online").run_sequence(seq)
    port = world.port()
    took = []
    for name in ("_window_track", "_scan_track"):
        def spy(*args, _f=getattr(port, name), _n=name, **kw):
            took.append(_n)
            return _f(*args, **kw)
        setattr(port, name, spy)
    got, _ = port.run_sequence(seq)
    assert took[0] == ("_window_track" if start == 2 else "_scan_track")
    _assert_labels_close(got[:start] + got[start + 1:], want[:start] + want[start + 1:], 1)
    # the entering frame carries object 2's ground truth
    gt2 = seq.labels[start][..., 0] == 2
    assert (got[start][gt2] == 2).all() and (want[start][gt2] == 2).all()
    assert float(np.mean(got[start] != want[start])) < 0.005
    assert all((lb == 2).sum() >= 10 for lb in want[start:])
    assert not any((lb == 2).any() for lb in got[:start])
    # object 1 re-solves at frames 2, 4, 6; object 2 every second frame of its own
    assert port.last_models[1].n_resolves.tolist() == [3, (6 - start) // 2]


def test_deferred_soft_volume_matches_jax(world):
    """The deferred merge's pre-merge volume, ground truth at the start
    frames; measured max abs difference 9.63e-5 at frame 3, held to 1e-3
    (the module docstring says why). And its labels (measured equal)."""
    seq = _sequence(6, 2)
    want, _ = world.jax("deferred").run_sequence(seq, soft=True)
    got, _ = world.port("deferred").run_sequence(seq, soft=True)
    assert got.shape == want.shape == (6, 2) + SIZE and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    for k in range(2):
        np.testing.assert_array_equal(got[0, k], seq.labels[0][..., 0] == k + 1)
    assert 0.05 < float((got[1:] > 0.5).mean()) < 0.95
    want_lb, _ = world.jax("deferred").run_sequence(seq)
    got_lb, _ = world.port("deferred").run_sequence(seq)
    _assert_labels_close(got_lb, want_lb, 2)


def _buffer_at(shape, offset):
    """An uninitialised uint8 array whose slot 1 (what the JAX tracker's
    _pack_aug_batch uploads) starts at `offset` mod 64 bytes."""
    size, slot = int(np.prod(shape)), int(np.prod(shape[1:]))
    raw = np.empty(size + 128, np.uint8)
    start = (offset - (raw.ctypes.data + slot)) % 64
    buf = raw[start:start + size].reshape(shape)
    assert buf[1:].ctypes.data % 64 == offset
    return buf


def test_jax_volume_ignores_augment_buffer_alignment(world):
    """The protection of this module's reference: frtm_tpu's two-object
    soft volume is equal, bit for bit, whether its augmenter's reused
    buffers are 64-byte aligned (which `jnp.asarray` aliases on the CPU
    backend) or not (which it copies). Without FreshBatches the aligned run
    feeds object 1's init from object 2's augmentation and the volume moves
    by 0.19."""
    seq = _sequence(6, 2)
    tracker = world.jax("deferred")
    assert isinstance(tracker.augmenter, FreshBatches)
    inner = tracker.augmenter.inner
    K = world.jcfg.aug_params["num_aug"]
    volumes = []
    for offset in (0, 1):
        inner._buf_key = (K,) + SIZE
        inner._buf_im = _buffer_at((K,) + SIZE + (3,), offset)
        inner._buf_lb = _buffer_at((K,) + SIZE + (1,), offset)
        volumes.append(tracker.run_sequence(seq, soft=True)[0])
        # the run did use the buffers it was given
        np.testing.assert_array_equal(inner._buf_im[0], seq.images[0])
    np.testing.assert_array_equal(volumes[0], volumes[1])
    # and the two lanes are two objects, not one batch twice
    assert np.abs(volumes[0][1:, 0] - volumes[0][1:, 1]).max() > 0.1


def test_batched_init_matches_jax(world):
    """Two objects through the JAX _init_objects_dense and the port's, on
    the same augment batches, each solving both objects as one batch:
    filters within 1e-3 of their peak (the ill-conditioned phase-1 solve;
    measured 4.0e-5 of it), scores on the tracked frames within 1e-4
    (measured 4.2e-5 at a peak of 0.58). Then the JAX side's models,
    converted, drive the port's loop to the JAX tracker's labels."""
    seq = _sequence(6, 2)
    jt, port = world.jax("online"), world.port()
    objects = port._collect_objects(seq)
    batches = [jt.augmenter.augment_first_frame(o[3], o[2][..., None], np.random.RandomState(0))
               for o in objects]
    ims = np.stack([b[0] for b in batches])
    lbs = np.stack([b[1] for b in batches])
    jp, js = jt._init_objects_dense(jt.backbone, jt._disc_params0, jnp.asarray(ims),
                                    jnp.asarray(lbs))
    layer = world.jcfg.disc.layer
    jp, js = jax.tree.map(np.asarray, (jp[layer], js[layer]))
    with torch.no_grad():
        models = port._init_objects_dense(
            torch.from_numpy(np.ascontiguousarray(ims.transpose(0, 1, 4, 2, 3))),
            torch.from_numpy(np.ascontiguousarray(lbs.transpose(0, 1, 4, 2, 3))))
        converted = disc_objects_from_jax(tuple(jp), (tuple(js.memory), tuple(js.cg),
                                                      js.frame_num), "cpu")
        frames = np.stack(seq.images[1:])
        feats = port._extract_sequence(port._upload_chunks(frames))
        scores = {}
        for name, (p, _) in (("port", models), ("jax", converted)):
            cft = project_all(feats[layer], p.project)
            scores[name] = classify_objects(cft, p.filter).numpy()
    (pt, st), (pj, sj) = models, converted
    for k in range(2):
        peak = float(pj.filter[k].abs().max())
        np.testing.assert_allclose(pt.filter[k].numpy(), pj.filter[k].numpy(), rtol=0,
                                   atol=1e-3 * peak)
    np.testing.assert_allclose(st.memory.weights.numpy(), sj.memory.weights.numpy(), atol=1e-7)
    np.testing.assert_array_equal(st.memory.labels.numpy(), sj.memory.labels.numpy())
    np.testing.assert_allclose(st.memory.pixel_weights.numpy(),
                               sj.memory.pixel_weights.numpy(), atol=1e-6)
    assert st.memory.current_size.tolist() == sj.memory.current_size.tolist() == [3, 3]
    assert st.frame_num == sj.frame_num == [0, 0]
    assert np.abs(scores["jax"]).max() > 0.1
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=0, atol=1e-4)

    # hand the JAX side's state to the port's loop
    want, _ = jt.run_sequence(seq)
    with torch.no_grad():
        lut = torch.tensor([0, 1, 2], dtype=torch.int32)
        masks = torch.from_numpy(np.stack([o[2] for o in objects]))
        got = port._window_track(feats, converted, [0, 0], masks, lut, SIZE)[0].numpy()
    _assert_labels_close([want[0]] + list(got), want, 2)


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_fused_tracker_records_the_scans_steps(world, monkeypatch):
    """With the recorder on, a six-frame two-object sequence (windows of 2
    over 5 tracked frames, re-solves after frames 2 and 4) records the
    scan's four steps inside its `scan` phase, all of the sequence's
    request, one `resolves` a resolve_due call (`resolve_replays` 0: on
    the CPU no CUDA graph serves one) and one `inits` for the init
    (`init_replays` 0 likewise); the labels are the same bytes as with the
    recorder off."""
    seq = _sequence(6, 2)
    port = world.port()
    plain, _ = port.run_sequence(seq)
    assert profiling.spans() == []
    calls = []
    inner = sequence_tracker.resolve_due

    def counted(*args):
        calls.append(args)
        return inner(*args)
    monkeypatch.setattr(sequence_tracker, "resolve_due", counted)
    profiling.reset()
    try:
        with profiling.recording():
            recorded, _ = port.run_sequence(seq)
        spans, counts = profiling.spans(), profiling.counts()
    finally:
        profiling.reset()
    assert all(a.tobytes() == b.tobytes() for a, b in zip(plain, recorded))
    assert len(plain) == len(recorded) == 6
    names = [s.name for s in spans]
    for name, n in (("run_sequence", 1), ("scan", 1), ("scan_prepare", 1), ("scan_forward", 3),
                    ("scan_insert", 3), ("scan_resolve", 2), ("label_download", 1)):
        assert names.count(name) == n, (name, names)
    scan_at = names.index("scan")
    scan = spans[scan_at]
    request = spans[names.index("run_sequence")].request
    assert request is not None and request.startswith(seq.name)
    for s in spans:
        assert s.request == request and s.cpu_ns <= s.end_ns - s.start_ns
        if s.name.startswith("scan_"):
            assert s.parent == scan_at and _inside(s, scan)
    assert len(calls) == 2 and counts == {"resolves": len(calls), "resolve_replays": 0,
                                          "inits": 1, "init_replays": 0}
    assert port.last_models[1].n_resolves.tolist() == [2, 2]


def test_profiled_run_dataset_records_downloads_and_png_writes(world, tmp_path):
    """profile=True turns the recorder on for run_dataset: each sequence is
    a request whose spans hold its label download and its PNG writes; a
    tracker that does not profile records nothing, and both write the same
    bytes."""
    class Dataset(list):
        name = "synthetic"

    seqs = Dataset([_sequence(3, 1, seed=2), _sequence(4, 2, seed=3)])
    for i, seq in enumerate(seqs):
        seq.name = f"s{i}"
    profiling.reset()
    try:
        world.port().run_dataset(seqs, tmp_path / "plain")
        assert profiling.spans() == []
        world.port(profile=True).run_dataset(seqs, tmp_path / "profiled")
        spans = profiling.spans()
    finally:
        profiling.reset()
    for seq in seqs:
        for f in seq.frame_names:
            assert ((tmp_path / "plain" / seq.name / f"{f}.png").read_bytes()
                    == (tmp_path / "profiled" / seq.name / f"{f}.png").read_bytes())
    dataset, = [s for s in spans if s.name == "run_dataset"]
    assert dataset.request is None
    requests = [s.request for s in spans if s.name == "run_sequence"]
    assert [r.split("#")[0] for r in requests] == ["s0", "s1"] and len(set(requests)) == 2
    for r in requests:
        mine = [s for s in spans if s.request == r]
        for name in ("prepare_inputs", "scan", "scan_forward", "label_download", "png_write"):
            assert sum(s.name == name for s in mine) >= 1, (r, name)
        write = next(s for s in mine if s.name == "png_write")
        download = next(s for s in mine if s.name == "label_download")
        assert download.end_ns <= write.start_ns and _inside(write, dataset)


def test_profiled_run_dataset_encodes_pngs_on_writer_threads(world, tmp_path):
    """Three sequences: each one's `png_encode` spans serve its request, run
    on threads other than the loop's (which holds `png_write`), lie inside
    `run_dataset` and after the sequence's label download; every file is
    there, and the last `png_write` ends after every `png_encode`."""
    class Dataset(list):
        name = "synthetic"

    seqs = Dataset([_sequence(3, 1, seed=2), _sequence(4, 2, seed=3), _sequence(3, 1, seed=4)])
    for i, seq in enumerate(seqs):
        seq.name = f"s{i}"
    profiling.reset()
    try:
        world.port(profile=True).run_dataset(seqs, tmp_path)
        spans = profiling.spans()
    finally:
        profiling.reset()
    for seq in seqs:
        assert sorted(p.name for p in (tmp_path / seq.name).iterdir()) == \
            sorted(f + ".png" for f in seq.frame_names)
    dataset, = [s for s in spans if s.name == "run_dataset"]
    writes = [s for s in spans if s.name == "png_write"]
    encodes = [s for s in spans if s.name == "png_encode"]
    assert len(writes) == 3 and encodes
    for write in writes:
        mine = [s for s in encodes if s.request == write.request]
        download = next(s for s in spans if s.name == "label_download"
                        and s.request == write.request)
        assert mine and write.request is not None
        for s in mine:
            assert s.thread != write.thread and _inside(s, dataset)
            assert download.end_ns <= s.start_ns
    assert {s.request for s in encodes} == {s.request for s in writes}
    assert max(s.end_ns for s in encodes) <= writes[-1].end_ns
