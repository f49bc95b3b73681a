"""The port's multi-sequence engine (frtm_tpu_torch/parallel/multi_sequence.py)
against frtm_tpu's ShardedSequenceTracker on a 2-device CPU mesh, with the
same weights (converted) and the JAX augmenter's batches fed to both, at the
tiny rn18 configuration of tests/test_multi_sequence.py and 64x96 frames.
This module holds the world both JAX comparisons use and the online one;
test_torch_multi_sequence_deferred.py the deferred merge's.

The weights are made as in test_torch_sequence_tracker.py (the score channel
of each TSE multiplied by SCORE_GAIN, the head scaled from the port's own
frame-1 logits), so that the masks are worth comparing.

One run of each engine holds one, two and three objects (three groups,
n_pad 1, 2 and 4), two lengths in one bucket (5 and 4 frames), and both
routes: the three-object sequence's object 3 enters at frame 1, off the
re-solve cadence, so its group takes the per-frame loop; the others the
windowed one. Bound, as for the fused tracker: labels under 0.5 % of a
frame (measured: 0 in every frame).

Against the port's own fused tracker, sequence by sequence: a sequence whose
object count is its group's width gives equal labels (measured: equal in
every frame). Bit-equality is not promised: the group decodes B x w x n
lanes in one batch, which a convolution may round differently in the last
bit from a batch of w x n. A sequence padded to its
group's width does not: the pad lane's zero mask takes part in the merge's
softmax (its odds add exp(-max odds) to the partition), as in frtm_tpu's
engine, and the ill-conditioned random target models carry that into the
labels (measured: 2.13 % of a frame for the three objects here).

frtm_tpu's engine runs behind FreshBatches: its _prepare asks for
copy=False, as its fused tracker does (test_torch_tracker.py).
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
from frtm_tpu.parallel import ShardedSequenceTracker as JaxSharded, make_mesh as jax_make_mesh
from frtm_tpu.runtime.sequence_tracker import BatchedSequenceTracker as JaxFused
from frtm_tpu_torch.config import eval_config
from frtm_tpu_torch.models.resnet import ResNet
from frtm_tpu_torch.models.seg_network import SegNetwork
from frtm_tpu_torch.parallel import ShardedSequenceTracker, make_mesh
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from frtm_tpu_torch.utils.convert import (disc_params_from_jax, resnet_from_jax,
                                          seg_network_from_jax)
from test_torch_tracker import FreshBatches, JaxAugmenterShim

torch.set_num_threads(2)

ARCH = "resnet18"
SIZE, SQUARE = (64, 96), 18
TINY = dict(init_iters=(2,), update_iters=(2,), memory_size=4, c_channels=8, train_skipping=2)
SCORE_GAIN = 300.0
HEAD_SPREAD = 0.5


def sequence(n_frames, n_objects, seed, name, starts=None):
    seq = make_moving_square_sequence(n_frames=n_frames, size=SIZE, square=SQUARE,
                                      n_objects=n_objects, seed=seed, name=name)
    if starts:
        seq.start_frames = starts
    return seq


class World:
    """The weights, both packages' configurations and the trackers' makers."""

    def __init__(self):
        tiny = lambda cfg: replace(cfg, disc=replace(cfg.disc, **TINY))
        self.jcfg = tiny(jax_eval_config(ARCH, fast=True, num_aug=2))
        self.tcfg = tiny(eval_config(ARCH, fast=True, num_aug=2))
        self.backbone = init_resnet(jax.random.PRNGKey(1), ARCH)
        self.ch = {L: c for L, c in resnet_out_channels(ARCH).items()
                   if L in self.jcfg.refnet_layers}
        refiner = init_seg_network(jax.random.PRNGKey(2), self.ch)
        for p in refiner["tse"].values():
            w = np.array(p["transform1"]["w"])
            w[:, :, -1, :] *= SCORE_GAIN          # HWIO: the score is the last input
            p["transform1"] = dict(p["transform1"], w=jnp.asarray(w))
        self.refiner = refiner
        p0 = JaxFused(self.jcfg, self.backbone, refiner)._disc_params0[self.jcfg.disc.layer]
        self.p0 = disc_params_from_jax(np.asarray(p0.project), np.asarray(p0.filter))
        vol, _ = self.fused("deferred").run_sequence(sequence(2, 2, 2, "probe"), soft=True)
        y = np.clip(vol[1].astype(np.float64), 1e-12, 1 - 1e-12)
        logits = np.log(y) - np.log1p(-y)
        scale = HEAD_SPREAD / float(logits.std())
        conv2 = refiner["up"]["conv2"]
        refiner["up"]["conv2"] = dict(conv2, w=conv2["w"] * scale,
                                      b=(conv2["b"] - float(np.median(logits))) * scale)

    def port_models(self):
        tb = ResNet(ARCH)
        tb.load_state_dict(resnet_from_jax(jax.tree.map(np.asarray, self.backbone)))
        tr = SegNetwork(self.ch)
        tr.load_state_dict(seg_network_from_jax(jax.tree.map(np.asarray, self.refiner)))
        return tb, tr

    def port_kwargs(self):
        return dict(device="cpu", disc_params0=self.p0,
                    augmenter=JaxAugmenterShim(self.jcfg.aug_params))

    def fused(self, merge_mode="online", cfg=None):
        return BatchedSequenceTracker(cfg or self.tcfg, *self.port_models(), extract_chunk=4,
                                      merge_mode=merge_mode, **self.port_kwargs())

    def sharded(self, merge_mode="online", cfg=None, **kw):
        return ShardedSequenceTracker(cfg or self.tcfg, *self.port_models(), make_mesh(device="cpu"),
                                      extract_chunk=4, length_bucket=4, merge_mode=merge_mode,
                                      **self.port_kwargs(), **kw)

    def jax_sharded(self, merge_mode):
        tracker = JaxSharded(self.jcfg, self.backbone, self.refiner, jax_make_mesh(2),
                             extract_chunk=4, length_bucket=4, merge_mode=merge_mode)
        tracker.augmenter = FreshBatches(tracker.augmenter)
        return tracker


@pytest.fixture(scope="module")
def world():
    return World()


def worst_gap(got, want, seq):
    """The largest share of a frame's pixels on which two label sequences
    differ. The comparison is not of constant masks: in `want` the
    background and every object that has started hold pixels in every
    tracked frame; with three objects the objects together do (at this size
    the random weights' target models lose some of three objects after
    frame 1, in both packages)."""
    assert len(got) == len(want) == len(seq)
    for t, lb in enumerate(want[1:], 1):
        ids = [i for f, new in seq.start_frames.items() if int(f) <= t for i in new]
        counts = [int((lb == i).sum()) for i in ids]
        assert int((lb == 0).sum()) >= 10, (seq.name, t)
        assert (min(counts) if len(seq.obj_ids) < 3 else sum(counts)) >= 10, (seq.name, t, counts)
    return max(float(np.mean(a != b)) for a, b in zip(got, want))


def spy_windows(tracker):
    """Records the window of every _track call."""
    windows = []
    track = tracker._track

    def spy(*args, **kw):
        windows.append(kw["window"])
        return track(*args, **kw)

    tracker._track = spy
    return windows


def test_groups_match_jax_online(world):
    """Mixed object counts, mixed lengths in one bucket and both routes in
    one run of each engine."""
    seqs = [sequence(5, 1, 10, "one"), sequence(5, 2, 11, "two_a"),
            sequence(4, 2, 12, "two_b"),
            sequence(5, 3, 13, "three", starts={"00000": [1, 2], "00001": [3]})]
    jt = world.jax_sharded("online")
    want = jt.run_sequences(seqs)
    assert {k[1] for k in jt._vscan_cache} == {True, False}
    port = world.sharded()
    windows = spy_windows(port)
    got = port.run_sequences(seqs)
    assert sorted(windows) == [1, 2, 2]          # three groups, the 4-lane one per frame
    fused = world.fused()
    for seq in seqs:
        n = len(seq.obj_ids)
        assert len(got[seq.name]) == len(seq)
        assert all(lb.dtype == np.uint8 and lb.shape == SIZE for lb in got[seq.name])
        np.testing.assert_array_equal(got[seq.name][0], seq.labels[0][..., 0] * (
            np.isin(seq.labels[0][..., 0], seq.start_frames["00000"])))
        gap_jax = worst_gap(got[seq.name], want[seq.name], seq)
        # the port's fused tracker on this sequence alone: equal labels
        # where no lane is padded
        alone, _ = fused.run_sequence(seq)
        gap_fused = worst_gap(got[seq.name], alone, seq)
        print(f"{seq.name}: labels against frtm_tpu {gap_jax:.5f}, against the fused "
              f"tracker {gap_fused:.5f}")
        assert gap_jax < 0.005, seq.name
        assert gap_fused == 0.0 if n == 1 << (n - 1).bit_length() else gap_fused < 0.05
