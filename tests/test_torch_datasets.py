"""The port's inference datasets (frtm_tpu_torch/data/datasets.py) against
frtm_tpu.data.datasets on fabricated trees: a miniature DAVIS (read as 2016,
which merges objects, and as 2017) and a miniature YouTube-VOS (meta.json, an
object entering mid-sequence, the valid split and the jj split lists). Both
packages must give the same names, lengths, frames, start labels, start
frames, object ids and annotation files, under `sequences`, `restart` and
`all_annotations`. Frames are JPEG, which the port reads through PIL as the
JAX package does, so the arrays are compared for equality."""
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from frtm_tpu.data import datasets as jd
from frtm_tpu_torch.data import datasets as pd
from frtm_tpu_torch.data.image import imwrite_indexed
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence

SIZE = (40, 56)


def _write_sequence(jpeg_dir, anno_dir, seq, anno_frames=None, enter=None):
    """enter: {object id: index of its first frame}; before it the object is
    absent from the annotations, as in YouTube-VOS."""
    jpeg_dir.mkdir(parents=True)
    anno_dir.mkdir(parents=True)
    for i, (name, im, lb) in enumerate(zip(seq.frame_names, seq.images, seq.labels)):
        Image.fromarray(im).save(jpeg_dir / f"{name}.jpg", quality=95)
        if anno_frames is not None and i not in anno_frames:
            continue
        lb = lb.copy()
        for obj, first in (enter or {}).items():
            if i < first:
                lb[lb == obj] = 0
        imwrite_indexed(anno_dir / f"{name}.png", lb)


@pytest.fixture(scope="module")
def davis(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis")
    seqs = [make_moving_square_sequence(n_frames=4, size=SIZE, square=10, n_objects=n,
                                        seed=n, name=name)
            for n, name in ((2, "bear"), (1, "camel"), (3, "dogs"))]
    for year in ("2016", "2017"):
        (root / "ImageSets" / year).mkdir(parents=True)
        (root / "ImageSets" / year / "val.txt").write_text(
            "".join(s.name + "\n" for s in reversed(seqs)))      # unsorted on disk
    for s in seqs:
        _write_sequence(root / "JPEGImages" / "480p" / s.name,
                        root / "Annotations" / "480p" / s.name, s)
    return root


@pytest.fixture(scope="module")
def ytvos(tmp_path_factory):
    root = tmp_path_factory.mktemp("ytvos")
    a = make_moving_square_sequence(n_frames=6, size=SIZE, square=10, n_objects=2, seed=7,
                                    name="0a1b2c")
    b = make_moving_square_sequence(n_frames=5, size=SIZE, square=10, n_objects=1, seed=8,
                                    name="ffee00")
    videos = {
        a.name: {"objects": {"1": {"category": "x", "frames": a.frame_names[0::2]},
                             "2": {"category": "y", "frames": a.frame_names[2::2]}}},
        b.name: {"objects": {"1": {"category": "x", "frames": b.frame_names[0::2]}}}}
    for split in ("valid", "train"):
        (root / split).mkdir()
    # valid: annotations every other frame, images of those frames; the
    # all-frames dump holds every frame
    for s, enter in ((a, {2: 2}), (b, {})):
        _write_sequence(root / "valid_all_frames" / "JPEGImages" / s.name,
                        root / "valid" / "Annotations" / s.name, s, anno_frames={0, 2, 4},
                        enter=enter)
        (root / "valid" / "JPEGImages" / s.name).mkdir(parents=True)
        for name in s.frame_names[0::2]:
            im = Image.open(root / "valid_all_frames" / "JPEGImages" / s.name / f"{name}.jpg")
            im.save(root / "valid" / "JPEGImages" / s.name / f"{name}.jpg", quality=95)
    (root / "valid" / "meta.json").write_text(json.dumps({"videos": videos}))
    # train: meta for every name of the jj lists; no files are needed to list them
    names = [s.strip() for f in ("ytvos_jjtrain.txt", "ytvos_jjvalid.txt")
             for s in open(Path(pd.__file__).parent / f)]
    (root / "train" / "meta.json").write_text(json.dumps({"videos": {
        n: {"objects": {"1": {"category": "x", "frames": ["00000"]}}} for n in names}}))
    return root


def _assert_same_dataset(got, want):
    assert got.name == want.name and len(got) == len(want) > 0
    assert got.sequences == want.sequences
    assert got.start_frames == want.start_frames
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert (g.name, g.dset_name, len(g), repr(g)) == (w.name, w.dset_name, len(w), repr(w))
        assert g.frame_names == w.frame_names and g.images == w.images
        assert g.obj_ids == w.obj_ids and g.start_frames == w.start_frames
        assert g.merge_objects == w.merge_objects
        assert hasattr(g, "annos") == hasattr(w, "annos")
        if hasattr(w, "annos"):
            assert g.annos == w.annos and len(g.annos) > 0
            ga, wa = g.annotations(), w.annotations()
            assert list(ga) == list(wa)
            for k in wa:
                np.testing.assert_array_equal(ga[k], wa[k])
        for preload in (False, True):
            if preload:
                g.preload()
                w.preload()
            for t in range(len(w)):
                (gi, gl, gn), (wi, wl, wn) = g[t], w[t]
                np.testing.assert_array_equal(gi, np.asarray(wi))
                assert gi.dtype == np.uint8 and gi.shape == SIZE + (3,)
                assert gn == wn
                np.testing.assert_array_equal(gl, wl)
                if wn:
                    assert gl.shape == SIZE + (1,) and gl.dtype == np.uint8


@pytest.mark.parametrize("year", ["2016", "2017"])
@pytest.mark.parametrize("kwargs", [{}, {"all_annotations": True}, {"restart": "camel"},
                                    {"sequences": ["dogs", "bear"]}],
                         ids=["plain", "annotations", "restart", "subset"])
def test_davis_matches_jax(davis, year, kwargs):
    got = pd.DAVISDataset(path=davis, year=year, split="val", **kwargs)
    want = jd.DAVISDataset(path=davis, year=year, split="val", **kwargs)
    _assert_same_dataset(got, want)
    assert got.name == f"dv{year}val"
    if not kwargs:
        assert got.sequences == ["bear", "camel", "dogs"]
        seq = got[2]
        assert seq.obj_ids == ([1] if year == "2016" else [1, 2, 3])
        assert sorted(np.unique(seq[0][1])) == ([0, 1] if year == "2016" else [0, 1, 2, 3])
        # flipped after construction, as the CLI does before scoring
        got.all_annotations = want.all_annotations = True
        _assert_same_dataset(got, want)
    if "restart" in kwargs:
        assert got.sequences == ["camel", "dogs"]
    if "sequences" in kwargs:
        assert got.sequences == ["bear", "dogs"]


@pytest.mark.parametrize("split", ["valid", "valid_all_frames"])
@pytest.mark.parametrize("kwargs", [{}, {"all_annotations": True}, {"restart": "ffee00"},
                                    {"sequences": ["0a1b2c"]}],
                         ids=["plain", "annotations", "restart", "subset"])
def test_ytvos_matches_jax(ytvos, split, kwargs):
    got = pd.YouTubeVOSDataset(path=ytvos, year="2018", split=split, **kwargs)
    want = jd.YouTubeVOSDataset(path=ytvos, year="2018", split=split, **kwargs)
    _assert_same_dataset(got, want)
    assert got.name == f"ytvos2018{split}" and got.meta == want.meta
    if not kwargs:
        seq = got[0]
        assert seq.name == "0a1b2c" and len(seq) == (6 if split.endswith("all_frames") else 3)
        assert seq.start_frames == {"00000": [1], "00002": [2]} and seq.obj_ids == [1, 2]
        # object 2 enters at frame 00002: only its label is handed out there
        entry = seq.frame_names.index("00002")
        im, lb, new = seq[entry]
        assert new == [2] and sorted(np.unique(lb)) == [0, 2]
        assert seq[entry - 1][1:] == ([], []) if entry > 1 else True


def test_jj_splits_and_selection_match_jax(ytvos):
    for split in ("jjval", "jjval_all_frames", "train"):
        got = pd.YouTubeVOSDataset(path=ytvos, year="2018", split=split)
        want = jd.YouTubeVOSDataset(path=ytvos, year="2018", split=split)
        assert got.sequences == want.sequences and got.name == want.name
        assert got.start_frames == want.start_frames
    assert len(pd.YouTubeVOSDataset(path=ytvos, year="2018", split="jjval")) == 300
    names = ["a", "b", "c", "d"]
    for kw in ({}, {"sequences": ["d", "b"]}, {"restart": "c"},
               {"sequences": ["a", "c", "d"], "restart": "c"}):
        assert pd._apply_selection(names, **kw) == jd._apply_selection(names, **kw)
    for bad in ({"sequences": ["zz"]}, {"restart": "zz"}):
        with pytest.raises(AssertionError):
            pd._apply_selection(names, **bad)
    with pytest.raises(FileNotFoundError):
        pd.DAVISDataset(path=ytvos / "nowhere", year="2017", split="val")
    with pytest.raises(FileNotFoundError):
        pd.YouTubeVOSDataset(path=ytvos / "nowhere", year="2018", split="valid")
