"""The traffic generator: the same seed gives the same frames and walk; any
seed walks the same table, in balanced chunks; objects start apart."""
from collections import Counter
from itertools import islice
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness.traffic import (GeneratedSequence, balanced_chunks, load_mix,
                                       make_frames, walk)

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))
BIG_SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("name", MIXES)
def test_mix_totals(name):
    mix = load_mix(TRAFFIC / f"{name}.json")
    frames = sum(s["frames"] for s in mix["sequences"])
    objects = sum(len(s["objects"]) for s in mix["sequences"])
    want = {"davis17": (30, 1999, 61)}[name]
    assert (len(mix["sequences"]), frames, objects) == want


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_walks_the_same_table_in_balanced_chunks(name):
    mix = load_mix(TRAFFIC / f"{name}.json")
    n = len(mix["sequences"])
    chunks = balanced_chunks(mix)
    assert sorted(i for c in chunks for i in c) == list(range(n))
    work = [sum(mix["sequences"][i]["frames"] + 30 * len(mix["sequences"][i]["objects"])
                for i in c) for c in chunks]
    assert max(work) <= 1.05 * min(work)
    for seed in (0, 1, BIG_SEED):
        lap = [i for c in islice(walk(mix, seed), len(chunks)) for i in c]
        assert Counter(lap) == Counter(range(n))
    assert list(islice(walk(mix, BIG_SEED), 7)) == list(islice(walk(mix, BIG_SEED), 7))
    starts = {next(walk(mix, s))[0] for s in range(12)}
    assert len(starts) > 1


def test_frames_are_a_function_of_the_seed():
    spec = {"name": "x", "frames": 6, "objects": [[20, 30], [16, 18], [12, 14]]}
    a, la = make_frames(spec, (64, 96), BIG_SEED, 3)
    b, lb = make_frames(spec, (64, 96), BIG_SEED, 3)
    c, _ = make_frames(spec, (64, 96), BIG_SEED + 1, 3)
    assert a.shape == (6, 64, 96, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert not np.array_equal(a, c)
    # every object present and apart in frame 0, with its full ellipse
    for k, (h, w) in enumerate(spec["objects"]):
        px = int((la == k + 1).sum())
        assert abs(px - np.pi / 4 * h * w) < 0.1 * h * w
    assert not np.array_equal(a[0], a[-1])     # the objects move


def test_sequence_interface_and_release():
    spec = {"name": "x", "frames": 4, "objects": [[20, 30]]}
    seq = GeneratedSequence(spec, (64, 96), 9, 0, visit=2)
    assert seq.name == "x.2" and len(seq) == 4 and seq.obj_ids == [1]
    assert seq.start_frames == {"00000": [1]}
    im, lb, new = seq[0]
    assert im.shape == (64, 96, 3) and new == [1] and lb.max() == 1
    assert seq[2][1] == [] and seq[2][2] == []
    first = seq.frames().copy()
    seq.preloaded = None
    assert seq.preloaded is None
    assert np.array_equal(seq.frames(), first)
