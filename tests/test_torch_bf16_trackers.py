"""Both trackers with compute_dtype="bfloat16" against frtm_tpu's in bfloat16,
on the fixture of test_torch_sequence_tracker.py (rn18, 48x64, 6 frames, the
same weights, starting filters and augment batches for both packages; the JAX
fused tracker behind FreshBatches), with one and with two objects.

In float32 the two packages' labels are equal on this fixture. In bfloat16
they cannot be: the fixture's masks are low-contrast by construction (the
head's logits have a spread of 0.5), and bfloat16 moves frtm_tpu's own labels
by 0.3-2.5 % of a frame against its own float32 run. That gap, measured in
the same test, is the yardstick: each bound is a multiple of it.

  fused tracker (backbone and decoder in bfloat16, the pyramid kept in it):
    the port's labels differ from frtm_tpu's bfloat16 labels by at most twice
    that gap, in the mean over the tracked frames and in the worst frame.
    Measured: 1.02 (one object) and 1.05 (two) of it in the mean, 1.22 and
    1.07 in the worst frame: the two bfloat16 runs lie as far from each other
    as either lies from float32, as two roundings of one computation do. The
    deferred soft volume: rms within twice frtm_tpu's own bfloat16-to-float32
    rms (measured 1.02), with ground truth exact at the start frames.
  host loop (backbone in bfloat16 emitting float32, decoder float32): at
    most 1.5 times the gap; measured 0.97 (one object) and 0.14 (two) in the
    worst frame.
And in every run at most 5 % of a frame, every object holding pixels in
every tracked frame.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from frtm_tpu.runtime.tracker import Tracker as JaxTracker
from frtm_tpu_torch.runtime.tracker import Tracker
from test_torch_sequence_tracker import SIZE, World, _sequence
from test_torch_tracker import FreshBatches, JaxAugmenterShim

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    return World()


def _gaps(a, b):
    """Fraction of differing pixels per tracked frame."""
    assert len(a) == len(b)
    return np.array([float(np.mean(x != y)) for x, y in zip(a[1:], b[1:])])


def _assert_within(got, want16, want32, factor, n_objects, seq):
    own, port = _gaps(want16, want32), _gaps(got, want16)
    assert own.max() > 0, "bfloat16 changed nothing in frtm_tpu: the yardstick is empty"
    assert port.mean() <= factor * own.mean(), (port, own)
    assert port.max() <= factor * own.max(), (port, own)
    assert port.max() < 0.05
    for out in (got, want16):
        np.testing.assert_array_equal(out[0], seq.labels[0][..., 0])
        for lb in out[1:]:
            assert lb.shape == SIZE and lb.dtype == np.uint8
            assert min(int((lb == i).sum()) for i in range(n_objects + 1)) >= 10


@pytest.mark.parametrize("n_objects", [1, 2])
def test_fused_tracker_in_bfloat16_matches_jax(world, n_objects):
    seq = _sequence(6, n_objects)
    want32, _ = world.jax("online").run_sequence(seq)
    jax16 = world.jax("online", "bfloat16")
    assert isinstance(jax16.augmenter, FreshBatches) and jax16.cfg.compute_dtype == "bfloat16"
    want16, _ = jax16.run_sequence(seq)
    port = world.port("online", "bfloat16")
    got, _ = port.run_sequence(seq)
    _assert_within(got, want16, want32, 2.0, n_objects, seq)
    # the pyramid stayed in bfloat16; target model and memory are float32
    assert port.last_feats_dtype == torch.bfloat16
    params, state = port.last_models
    assert params.filter.dtype == params.project.dtype == torch.float32
    assert state.n_resolves.tolist() == [2] * n_objects
    # and bfloat16 did change the port's own labels
    got32, _ = world.port("online").run_sequence(seq)
    assert _gaps(got, got32).max() > 0


def test_deferred_soft_volume_in_bfloat16_matches_jax(world):
    seq = _sequence(6, 2)
    want32, _ = world.jax("deferred").run_sequence(seq, soft=True)
    want16, _ = world.jax("deferred", "bfloat16").run_sequence(seq, soft=True)
    got, _ = world.port("deferred", "bfloat16").run_sequence(seq, soft=True)
    assert got.shape == want16.shape == (6, 2) + SIZE and got.dtype == np.float32
    rms = lambda a: float(np.sqrt(np.mean(np.square(a[1:], dtype=np.float64))))
    own = rms(want16 - want32)
    assert own > 1e-4
    assert rms(got - want16) <= 2.0 * own, rms(got - want16) / own
    assert rms(got - want32) <= 1.5 * own, rms(got - want32) / own
    for k in range(2):
        np.testing.assert_array_equal(got[0, k], seq.labels[0][..., 0] == k + 1)


@pytest.mark.parametrize("n_objects", [1, 2])
def test_host_loop_tracker_in_bfloat16_matches_jax(world, n_objects):
    seq = _sequence(6, n_objects)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        jax_tracker = JaxTracker(replace(world.jcfg, compute_dtype=dtype), world.backbone,
                                 world.refiner)
        outs[dtype], _ = jax_tracker.run_sequence(seq)
    port = Tracker(replace(world.tcfg, compute_dtype="bfloat16"), *world.port_models(),
                   device="cpu", disc_params0=world.p0,
                   augmenter=JaxAugmenterShim(world.jcfg.aug_params))
    got, fps = port.run_sequence(seq)
    assert fps > 0 and port.dtype == torch.bfloat16
    assert port.backbone_c.conv1.weight.dtype == torch.bfloat16
    assert port.backbone.conv1.weight.dtype == torch.float32       # the module handed in is kept
    assert next(port.refiner.parameters()).dtype == torch.float32  # the decoder stays float32
    _assert_within(got, outs["bfloat16"], outs["float32"], 1.5, n_objects, seq)
    assert all(t.state.n_resolves.tolist() == [2] for t in port.targets.values())
