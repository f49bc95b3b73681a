"""The fused tracker with `augment_backend="device"`: frtm_tpu's
BatchedSequenceTracker and the port's on the CPU, each with its own
DeviceAugmenter, at the sizes and weights of test_torch_sequence_tracker.py
(its World: rn18, 48x64, the score weights raised and the head scaled so
that every object holds pixels), with one and with two objects; and the
port's two backends against each other.

frtm_tpu's device path augments from its start frames' device copies and
packs nothing through host buffers, so it reads none of the reused host
buffers that FreshBatches guards against (test_torch_tracker.py): these JAX
trackers run without it.

The augment batches agree up to `floor` flips of one grey level on under
0.1 % of their values (test_torch_device_augmenter.py); labels and counts
are equal. Bound: labels differ on under 0.5 % of a frame's pixels, the
bound of test_torch_sequence_tracker.py; measured at most 0.033 % (one
pixel of 3,072) with one object, with two, and with object 2 entering at
frame 3 (0 at its entry frame).
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from frtm_tpu.runtime.sequence_tracker import BatchedSequenceTracker as JaxFused
from frtm_tpu_torch.config import eval_aug_params
from frtm_tpu_torch.data.image import imread
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
from frtm_tpu_torch.models.augmenter import ImageAugmenter
from frtm_tpu_torch.models.device_augmenter import DeviceAugmenter
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from test_torch_sequence_tracker import World, _assert_labels_close, _sequence

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    return World()


def _trackers(world, merge_mode="online"):
    jt = JaxFused(world.jcfg, world.backbone, world.refiner, extract_chunk=4, scan_bucket=8,
                  merge_mode=merge_mode, augment_backend="device")
    pt = BatchedSequenceTracker(world.tcfg, *world.port_models(), extract_chunk=4,
                                merge_mode=merge_mode, device="cpu", disc_params0=world.p0,
                                augment_backend="device")
    return jt, pt


@pytest.mark.parametrize("n_objects", [1, 2])
def test_device_backend_tracker_matches_jax(world, n_objects):
    seq = _sequence(6, n_objects)
    jt, pt = _trackers(world)
    assert isinstance(pt.augmenter, DeviceAugmenter) and not pt.aug_compact
    want, _ = jt.run_sequence(seq)
    got, fps = pt.run_sequence(seq)
    assert fps > 0 and all(o.dtype == np.uint8 and o.shape == seq.images[0].shape[:2]
                           for o in got)
    _assert_labels_close(got, want, n_objects)
    np.testing.assert_array_equal(got[0], seq.labels[0][..., 0])
    # every object augmented inside the timed region, no host batches
    assert set(pt.last_phase_stats) == {"extract", "augment", "disc_init", "scan"}
    assert pt.last_phase_stats["augment"]["count"] == n_objects
    _, state = pt.last_models
    assert state.n_resolves.tolist() == [2] * n_objects


def test_device_backend_pipeline_and_mid_sequence_entry(world, tmp_path):
    """Object 2 entering at frame 3 (the per-frame loop) against frtm_tpu,
    and the pipelined run_dataset: its prepare step leaves the augment to
    the timed region, tags no fps line ex-augment, and writes the labels
    that run_sequence returns."""
    seq = _sequence(7, 2, starts={"00000": [1], "00003": [2]}, seed=4)
    jt, pt = _trackers(world)
    want, _ = jt.run_sequence(seq)
    got, _ = pt.run_sequence(seq)
    _assert_labels_close(got[:3] + got[4:], want[:3] + want[4:], 1)
    assert float(np.mean(got[3] != want[3])) < 0.005
    prep = pt.prepare_sequence(seq)
    assert prep["aug_batches"] is None

    class Dataset(list):
        name = "synth"

    out = io.StringIO()
    with redirect_stdout(out):
        pt.run_dataset(Dataset([seq]), tmp_path, pipeline=True)
    assert "(ex-augment)" not in out.getvalue() and "Pipelined dataset pass" in out.getvalue()
    for t, name in enumerate(seq.frame_names):
        np.testing.assert_array_equal(imread(tmp_path / seq.name / f"{name}.png")[..., 0],
                                      got[t])


@pytest.mark.parametrize("size", [(96, 128), (240, 427)])
def test_host_and_device_augmenters_agree(size):
    """The port's two augmenters on one frame and RandomState accept the
    same specs: equal labels, images within one grey level on under 0.1 %
    of the values (the host path blurs with a convolution, the device path
    with shifted multiply-adds, and maps the paste's sub-box, not the crop).
    Measured: labels equal, images at most 1 apart on 5.4e-6 to 7.6e-5 of
    the values (96x128 to 480x854, two objects each)."""
    seq = make_moving_square_sequence(n_frames=2, size=size, square=size[0] // 4,
                                      n_objects=2, seed=0)
    for obj in (1, 2):
        mask = (seq.labels[0][..., 0] == obj).astype(np.float32)[..., None]
        hi, hl = ImageAugmenter(eval_aug_params(5), "cpu").augment_first_frame(
            seq.images[0], mask, np.random.RandomState(0))
        di, dl = DeviceAugmenter(eval_aug_params(5), "cpu").augment_first_frame(
            seq.images[0], mask, np.random.RandomState(0))
        assert torch.equal(hl, dl)
        diff = (hi.float() - di.float()).abs()
        assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) < 1e-3


def test_host_and_device_backends_track_alike(world):
    """The fused tracker with either backend, two objects: labels differ on
    under 0.5 % of a frame (the bound above); measured equal."""
    seq = _sequence(6, 2)
    got = {}
    for backend in ("host", "device"):
        tracker = BatchedSequenceTracker(world.tcfg, *world.port_models(), extract_chunk=4,
                                         device="cpu", disc_params0=world.p0,
                                         augment_backend=backend)
        got[backend], _ = tracker.run_sequence(seq)
    _assert_labels_close(got["device"], got["host"], 2)
