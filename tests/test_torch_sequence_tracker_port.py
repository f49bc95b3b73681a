"""The port's fused tracker against the port's own host-loop Tracker and
against itself (windowed against per-frame loop, decode_chunk on against off,
5 frames against the first 5 of 6, compact against dense augment, preloaded
against plain), on the CPU with the port's own augmenter and seeded weights.
The refiner is made to read its scores and its head is scaled as in
test_torch_sequence_tracker.py, so the masks hold every object.

Mid-sequence entry is held against the JAX fused tracker there, not against
the host loop here: before an object enters, the fused tracker (the JAX one
too) merges its silent lane as a third contestant with odds 0, which the
host loop does not have; on these low-contrast masks that moves 20 % of the
labels, on confident masks nothing."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from frtm_tpu_torch.config import eval_config
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
from frtm_tpu_torch.models.discriminator import DiscParams, disc_init
from frtm_tpu_torch.models.resnet import resnet_out_channels
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from frtm_tpu_torch.runtime.tracker import Tracker
from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network
from test_torch_tracker import SMALL

# The suite runs under xdist with about as many workers as the machine has
# cores. PyTorch would give every worker a thread per core, and at these
# sizes the workers then spend their time waiting for each other: this
# module's tests took 30-77 s each that way and 1-5 s with two threads.
torch.set_num_threads(2)

ARCH = "resnet18"
SIZE, SQUARE = (96, 128), 24
SCORE_GAIN = 300.0
HEAD_SPREAD = 0.5


def _sequence(n_frames, n_objects=2, starts=None, seed=2):
    seq = make_moving_square_sequence(n_frames=n_frames, size=SIZE, square=SQUARE,
                                      n_objects=n_objects, seed=seed)
    if starts:
        seq.start_frames = starts
    return seq


@pytest.fixture(scope="module")
def world():
    cfg = eval_config(ARCH, fast=True, num_aug=3)
    cfg = replace(cfg, disc=replace(cfg.disc, **SMALL))
    ch = {L: c for L, c in resnet_out_channels(ARCH).items() if L in cfg.refnet_layers}
    backbone = init_resnet(ARCH, torch.Generator().manual_seed(1), "cpu")
    refiner = init_seg_network(ch, torch.Generator().manual_seed(2), device="cpu")
    with torch.no_grad():
        for L in refiner.layers:
            refiner.TSE[L].transform[0].weight[:, -1] *= SCORE_GAIN
    probe = BatchedSequenceTracker(cfg, backbone, refiner, merge_mode="deferred", device="cpu")
    vol, _ = probe.run_sequence(_sequence(2), soft=True)
    y = np.clip(vol[1].astype(np.float64), 1e-12, 1 - 1e-12)
    logits = np.log(y) - np.log1p(-y)
    with torch.no_grad():
        conv2 = refiner.project.conv2
        conv2.weight.mul_(HEAD_SPREAD / float(logits.std()))
        conv2.bias.sub_(float(np.median(logits))).mul_(HEAD_SPREAD / float(logits.std()))
    return cfg, backbone, refiner


def _fused(world, **kw):
    cfg, backbone, refiner = world
    return BatchedSequenceTracker(cfg, backbone, refiner, extract_chunk=4, device="cpu", **kw)


def _worst(a, b):
    assert len(a) == len(b)
    return max(float(np.mean(x != y)) for x, y in zip(a, b))


def _holds_every_object(outputs, n_objects):
    return all(min(int((lb == i).sum()) for i in range(n_objects + 1)) >= 10 for lb in outputs)


@pytest.mark.parametrize("n_objects", [1, 2])
def test_fused_tracker_matches_host_loop(world, n_objects):
    """Same math in another order of work: measured equal labels."""
    seq = _sequence(6, n_objects)
    cfg, backbone, refiner = world
    fused = _fused(world)
    got, _ = fused.run_sequence(seq)
    host = Tracker(cfg, backbone, refiner, device="cpu")
    want, _ = host.run_sequence(seq)
    assert _worst(got, want) < 0.005
    assert _holds_every_object(got[1:], n_objects)
    assert fused.last_models[1].n_resolves.tolist() == \
        [int(t.state.n_resolves) for t in host.targets.values()] == [2] * n_objects


def test_windowed_loop_equals_per_frame_loop(world):
    """With every start frame on a window boundary (object 2 enters at
    frame 2) the two loops take the same steps: equal labels."""
    seq = _sequence(7, 2, starts={"00000": [1], "00002": [2]}, seed=4)
    windowed = _fused(world)
    windowed._scan_track = None          # the aligned sequence must not need it
    out_w, _ = windowed.run_sequence(seq)
    perframe = _fused(world)
    perframe._window_track = perframe._scan_track
    out_f, _ = perframe.run_sequence(seq)
    for a, b in zip(out_w, out_f):
        np.testing.assert_array_equal(a, b)
    assert _holds_every_object(out_w[3:], 2)
    assert windowed.last_models[1].n_resolves.tolist() == \
        perframe.last_models[1].n_resolves.tolist() == [3, 2]


def test_decode_chunk_changes_nothing(world):
    seq = _sequence(5, 2)
    plain, _ = _fused(world, decode_chunk=0).run_sequence(seq)
    chunked = _fused(world, decode_chunk=2)      # window x objects = 4: two sub-batches
    calls = []
    decode = chunked._decode
    chunked._decode = lambda s, r, size: calls.append(s.shape[0]) or decode(s, r, size)
    got, _ = chunked.run_sequence(seq)
    assert calls == [4, 4]
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)


def test_five_frames_equal_the_first_five_of_six(world):
    """What the JAX package's bucket padding had to keep: the frames a
    sequence does not have change nothing in those it has. The last window
    of the 6-frame run is short."""
    out5, _ = _fused(world).run_sequence(_sequence(5))
    out6, _ = _fused(world).run_sequence(_sequence(6))
    assert len(out5) == 5 and len(out6) == 6
    for a, b in zip(out5, out6[:5]):
        np.testing.assert_array_equal(a, b)


def test_compact_augment_matches_dense(world):
    """aug_compact composes the same batches but for blurred warped
    backgrounds (1 count): measured equal labels."""
    seq = _sequence(6)
    dense, _ = _fused(world).run_sequence(seq)
    compact, _ = _fused(world, aug_compact=True).run_sequence(seq)
    assert _worst(compact, dense) < 0.005
    assert _holds_every_object(compact[1:], 2)


def test_prepared_sequence_and_given_batches_change_nothing(world):
    seq = _sequence(5)
    tracker = _fused(world)
    want, _ = tracker.run_sequence(seq)
    prep = tracker.prepare_sequence(seq)
    assert len(prep["chunks"]) == 1 and prep["chunks"][0].shape == (4,) + SIZE + (3,)
    got, _ = tracker.run_sequence(seq, preloaded=prep)
    again, _ = tracker.run_sequence(seq, aug_batches=prep["aug_batches"], speedrun=True)
    assert "augment" not in tracker.last_phase_stats
    for a, b, c in zip(want, got, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_uploaded_augment_batch_survives_the_next_augment(world):
    """On device="cpu" `.to(device)` returns its argument, so a packed
    batch shares memory with what the augmenter returned: the first
    object's batch must not change when the second object is augmented
    (the pipelined run_dataset prepares sequence i + 1 while sequence i
    still holds its batches)."""
    seq = _sequence(3)
    tracker = _fused(world)
    objects = tracker._collect_objects(seq)
    first = tracker._augment_objects(objects[:1])[0]
    kept = [t.clone() for t in first]
    both = tracker._augment_objects(objects)
    other = tracker._augment_objects(_fused(world)._collect_objects(_sequence(3, seed=5)))
    for t, k, again in zip(first, kept, both[0]):
        assert torch.equal(t, k) and torch.equal(t, again)
    assert not torch.equal(both[0][0], both[1][0]) and not torch.equal(both[0][0], other[0][0])
    assert first[0].data_ptr() != both[0][0].data_ptr()


def test_deferred_labels_and_one_frame_sequences(world):
    seq = _sequence(5)
    deferred = _fused(world, merge_mode="deferred")
    labels, _ = deferred.run_sequence(seq)
    assert len(labels) == 5 and all(lb.dtype == np.uint8 and lb.shape == SIZE for lb in labels)
    np.testing.assert_array_equal(labels[0], seq.labels[0][..., 0])
    assert "deferred_merge" in deferred.last_phase_stats
    with pytest.raises(ValueError):
        _fused(world).run_sequence(seq, soft=True)
    one, _ = _fused(world).run_sequence(_sequence(1))
    assert len(one) == 1
    np.testing.assert_array_equal(one[0], seq.labels[0][..., 0])
    empty = _sequence(3)
    empty.start_frames = {}
    with pytest.raises(ValueError):
        _fused(world).run_sequence(empty)


def test_what_is_not_ported_raises(world):
    """Multilayer models and clamp_output are ported now (they construct);
    the device augmenter still raises, as do names nobody knows."""
    cfg, backbone, refiner = world
    for tracker in (BatchedSequenceTracker, Tracker):
        ml = tracker(replace(cfg, disc_layers=("layer4", "layer3")), backbone, refiner,
                     device="cpu")
        assert list(ml.disc_cfgs) == ["layer3", "layer4"] and ml.multilayer
        assert not tracker(replace(cfg, disc=replace(cfg.disc, clamp_output=True)), backbone,
                           refiner, device="cpu").multilayer
    for tracker in (BatchedSequenceTracker, Tracker):
        with pytest.raises(ValueError):       # bfloat16 is taken, other names are not
            tracker(replace(cfg, compute_dtype="float16"), backbone, refiner, device="cpu")
        assert tracker(replace(cfg, compute_dtype="bfloat16"), backbone, refiner,
                       device="cpu").dtype == torch.bfloat16
    with pytest.raises(NotImplementedError):
        BatchedSequenceTracker(cfg, backbone, refiner, device="cpu", augment_backend="device")
    with pytest.raises(ValueError):
        BatchedSequenceTracker(cfg, backbone, refiner, device="cpu", merge_mode="late")
    with pytest.raises(ValueError):
        disc_init(DiscParams(torch.zeros(1, 2, 3, 1, 1), torch.zeros(1, 1, 2, 3, 3)),
                  torch.zeros(1, 2, 3, 4, 4), torch.zeros(1, 2, 1, 8, 8),
                  replace(cfg.disc, in_channels=3, c_channels=2, solver="direct"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):     # the card is the default, and there is none
            BatchedSequenceTracker(cfg, backbone, refiner)
