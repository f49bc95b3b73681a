"""The port's multi-sequence engine against the port's own fused tracker,
which test_torch_sequence_tracker.py holds against frtm_tpu; the engine
itself is held against frtm_tpu's in test_torch_multi_sequence*.py. The
weights are the port's own seeded ones, made as there (the score channels of
each TSE multiplied by SCORE_GAIN, the head scaled from frame 1's logits);
the tiny rn18 configuration of tests/test_multi_sequence.py, 64x96 frames.

Covered here: groups of sequences with as many objects as their group's
width give the fused tracker's labels, online and deferred, and with a
multilayer target model (measured: equal in every frame); a preloaded
sequence, the labels left on the device and the timer's phases; the mesh's ranks
split each chunk and together give a world of one's labels; run_dataset's
chunks, restart, speedrun and pipeline write what run_sequences returns;
a chunk's preparations are released before the next chunk runs.
"""
import gc
import weakref
from dataclasses import replace

import numpy as np
import pytest
import torch

from frtm_tpu_torch.config import eval_config
from frtm_tpu_torch.data.image import imread
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
from frtm_tpu_torch.models.resnet import resnet_out_channels
from frtm_tpu_torch.parallel import Mesh, ShardedSequenceTracker, make_mesh
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network
from frtm_tpu_torch.utils.profiling import PhaseTimer

torch.set_num_threads(2)

ARCH = "resnet18"
SIZE, SQUARE = (64, 96), 18
TINY = dict(init_iters=(2,), update_iters=(2,), memory_size=4, c_channels=8, train_skipping=2)
SCORE_GAIN = 300.0
HEAD_SPREAD = 0.5
LAYERS = ("layer3", "layer4")


def sequence(n_frames, n_objects, seed, name, starts=None):
    seq = make_moving_square_sequence(n_frames=n_frames, size=SIZE, square=SQUARE,
                                      n_objects=n_objects, seed=seed, name=name)
    if starts:
        seq.start_frames = starts
    return seq


class World:
    def __init__(self):
        self.backbone = init_resnet(ARCH, torch.Generator().manual_seed(1), "cpu")
        self.cfgs = {}
        self.refiners = {}
        for layers in ((), LAYERS):
            cfg = eval_config(ARCH, fast=True, num_aug=2)
            cfg = replace(cfg, disc=replace(cfg.disc, **TINY), disc_layers=layers)
            self.cfgs[layers] = cfg
            self.refiners[layers] = self._refiner(cfg, len(layers) or 1)

    def _refiner(self, cfg, n_scores):
        ch = {L: c for L, c in resnet_out_channels(ARCH).items() if L in cfg.refnet_layers}
        refiner = init_seg_network(ch, torch.Generator().manual_seed(2), in_channels=n_scores,
                                   device="cpu")
        with torch.no_grad():
            for tse in refiner.TSE.values():
                tse.transform[0].weight[:, -n_scores:] *= SCORE_GAIN
            vol, _ = BatchedSequenceTracker(cfg, self.backbone, refiner, merge_mode="deferred",
                                            device="cpu").run_sequence(
                sequence(2, 2, 2, "probe"), soft=True)
            y = np.clip(vol[1].astype(np.float64), 1e-12, 1 - 1e-12)
            logits = np.log(y) - np.log1p(-y)
            conv2 = refiner.project.conv2
            conv2.weight.mul_(HEAD_SPREAD / float(logits.std()))
            conv2.bias.sub_(float(np.median(logits))).mul_(HEAD_SPREAD / float(logits.std()))
        return refiner

    def fused(self, merge_mode="online", layers=()):
        return BatchedSequenceTracker(self.cfgs[layers], self.backbone, self.refiners[layers],
                                      extract_chunk=4, merge_mode=merge_mode, device="cpu")

    def sharded(self, merge_mode="online", layers=(), mesh=None, **kw):
        return ShardedSequenceTracker(self.cfgs[layers], self.backbone, self.refiners[layers],
                                      mesh or make_mesh(), extract_chunk=4, length_bucket=4,
                                      merge_mode=merge_mode, device="cpu", **kw)


@pytest.fixture(scope="module")
def world():
    return World()


def assert_equal_labels(got, want, seq):
    assert len(got) == len(want) == len(seq)
    for t, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{seq.name} frame {t}")
    # not constant masks: the background and every started object hold pixels
    for t, lb in enumerate(want[1:], 1):
        ids = [0] + [i for f, new in seq.start_frames.items() if int(f) <= t for i in new]
        assert min(int((lb == i).sum()) for i in ids) >= 10, (seq.name, t)


@pytest.mark.parametrize("merge_mode, layers", [("online", ()), ("deferred", ()),
                                                ("online", LAYERS)])
def test_group_equals_fused_tracker(world, merge_mode, layers):
    """Three two-object sequences of two lengths in one group (object 2 of
    one entering at frame 2), and one alone in a group of one."""
    seqs = [sequence(5, 2, 30, "a"), sequence(4, 2, 31, "b"),
            sequence(5, 2, 32, "c", starts={"00000": [1], "00002": [2]}),
            sequence(9, 2, 33, "alone")]
    got = world.sharded(merge_mode, layers).run_sequences(seqs)
    fused = world.fused(merge_mode, layers)
    for seq in seqs:
        assert_equal_labels(got[seq.name], fused.run_sequence(seq)[0], seq)


def test_prepared_inputs_device_labels_and_phases(world):
    """_prepare on prepare_inputs()'s preload, the group key, the labels
    left on the device (as_device) and the timer's three phases."""
    seq = sequence(4, 2, 34, "pre")
    tracker = world.sharded()
    key = tracker._group_key_meta(seq)
    prep = tracker._prepare(seq, preloaded=tracker.prepare_inputs(seq))
    assert prep["group_key"] == key == (SIZE, 4, 2) and prep["n_track"] == 3
    timer = PhaseTimer(sync=False)
    got = tracker._run_group([(seq, prep)], key, timer=timer)[seq.name]
    assert set(timer.stats()) == {"group_feats", "group_init", "group_scan"}
    assert_equal_labels(got, world.fused().run_sequence(seq)[0], seq)
    labels = tracker._run_group([(seq, prep)], key, as_device=True)
    assert labels.shape == (1, 3) + SIZE and labels.dtype == torch.uint8
    np.testing.assert_array_equal(labels[0].numpy(), np.stack(got[1:]))


def test_ranks_split_each_chunk(world):
    """Two ranks of a mesh of two, without processes: each tracks its
    contiguous rows of each group (batch_rows), and together they give a
    world of one's labels."""
    seqs = [sequence(5, 1, 40 + i, f"r{i}") for i in range(3)] + [sequence(5, 2, 43, "r3")]
    whole = world.sharded().run_sequences(seqs)
    parts = [world.sharded(mesh=Mesh(group=None, rank=r, size=2, device=torch.device("cpu")))
             .run_sequences(seqs) for r in range(2)]
    assert sorted(parts[0]) == ["r0", "r1", "r3"] and sorted(parts[1]) == ["r2"]
    for part in parts:
        for name, labels in part.items():
            for a, b in zip(labels, whole[name]):
                np.testing.assert_array_equal(a, b)


def read_pngs(root, seqs):
    return {(s.name, f): imread(root / s.name / f"{f}.png").squeeze() for s in seqs
            for f in s.frame_names}


def test_run_dataset_chunks_restart_speedrun_pipeline(world, tmp_path, capsys):
    """Five sequences in two groups, chunks of two: the PNGs equal what
    run_sequences returns, with and without speedrun and pipeline; restart
    skips the sequences before the named one."""
    seqs = [sequence(4, 1, 50 + i, f"q{i}") for i in range(3)] + \
        [sequence(4, 2, 53 + i, f"p{i}") for i in range(2)]
    want = world.sharded().run_sequences(seqs)

    tracker = world.sharded()
    fps = tracker.run_dataset(seqs, tmp_path / "a", chunk_multiple=2)
    out = capsys.readouterr().out
    assert fps > 0 and "fps aggregate" in out and "fps per-sequence mean" in out
    assert "chunks of 2 run concurrently" in out and "speedrun" not in out
    pngs = read_pngs(tmp_path / "a", seqs)
    for (name, f), lb in pngs.items():
        np.testing.assert_array_equal(lb, want[name][int(f)])

    tracker.run_dataset(seqs, tmp_path / "b", chunk_multiple=2, speedrun=True, pipeline=True)
    out = capsys.readouterr().out
    # (key, width): one-object chunks of 2 and 1, the two-object chunk of 2
    assert "speedrun: warmed 3 group program(s) pre-clock" in out
    assert read_pngs(tmp_path / "b", seqs).keys() == pngs.keys()
    for key, lb in read_pngs(tmp_path / "b", seqs).items():
        np.testing.assert_array_equal(lb, pngs[key])

    tracker.run_dataset(seqs, tmp_path / "c", chunk_multiple=2, restart="q2")
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == ["p0", "p1", "q2"]


class Token:
    """Weakref-able marker attached to each prepared sequence."""


@pytest.mark.parametrize("pipeline", [False, True])
def test_prepared_chunks_are_released(world, tmp_path, pipeline):
    """When a chunk starts tracking, no earlier chunk's preparation
    (frames, uploads, augment batches) is alive, with or without the
    pipelined preparation of the next chunk."""
    seqs = [sequence(3, 1, 60 + i, f"m{i}") for i in range(5)]
    tracker = world.sharded()
    refs, alive_at_call = [], []
    run_group = tracker._run_group

    def spy(seq_preps, key, **kw):
        gc.collect()
        alive_at_call.append(sum(r() is not None for r in refs))
        for _, prep in seq_preps:
            prep["token"] = Token()
            refs.append(weakref.ref(prep["token"]))
        return run_group(seq_preps, key, **kw)

    tracker._run_group = spy
    tracker.run_dataset(seqs, tmp_path, pipeline=pipeline)
    assert len(refs) == 5 and len(alive_at_call) == 5
    assert max(alive_at_call) == 0, alive_at_call
