"""The port's training datasets (data/training_datasets.py) against
frtm_tpu's on fabricated DAVIS-train (480x854) and YouTube-VOS-train
(720x1280 and 360x640) trees: the occlusion rules, the visibility tables and
their cache (each package reads the other's), the epoch's sample specs under
equally seeded generators, and every loaded (image, label) pair."""
import random

import numpy as np
import pytest
from PIL import Image

from frtm_tpu.data import training_datasets as jd
from frtm_tpu.data.image import imwrite_indexed
from frtm_tpu.data.synthetic import make_moving_square_sequence
from frtm_tpu_torch.data import training_datasets as td

JJTRAIN = [s.strip() for s in open(td.__file__.replace("training_datasets.py",
                                                       "ytvos_jjtrain.txt"))]


def _write_seq(jpeg_dir, anno_dir, seq, occlude=None):
    jpeg_dir.mkdir(parents=True)
    anno_dir.mkdir(parents=True)
    for t, (name, im, lb) in enumerate(zip(seq.frame_names, seq.images, seq.labels)):
        if occlude is not None and t in occlude[1]:
            lb = np.where(lb == occlude[0], 0, lb).astype(np.uint8)
        Image.fromarray(im).save(jpeg_dir / f"{name}.jpg", quality=90)
        imwrite_indexed(anno_dir / f"{name}.png", lb)


@pytest.fixture(scope="module")
def davis(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis")
    seqs = [make_moving_square_sequence(n_frames=6, size=(480, 854), square=90, n_objects=n,
                                        seed=s, name=f"seq{s}") for s, n in [(0, 1), (1, 2)]]
    seqs.append(make_moving_square_sequence(n_frames=3, size=(480, 854), square=90,
                                            seed=2, name="short"))  # under min_seq_length
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "train.txt").write_text(
        "".join(s.name + "\n" for s in seqs))
    for i, s in enumerate(seqs):
        # object 2 of seq1 leaves the frame for two frames (occluded there)
        _write_seq(root / "JPEGImages" / "480p" / s.name, root / "Annotations" / "480p" / s.name,
                   s, occlude=(2, (2, 3)) if i == 1 else None)
    return root


@pytest.fixture(scope="module")
def ytvos(tmp_path_factory):
    """Three jjtrain sequences: two of 720x1280 (area) and one of 360x640
    (cubic), under the names the jjtrain list gives."""
    root = tmp_path_factory.mktemp("ytvos")
    for k, size in enumerate([(720, 1280), (360, 640), (720, 1280)]):
        seq = make_moving_square_sequence(n_frames=5, size=size, square=size[0] // 5,
                                          n_objects=2, seed=10 + k, name=JJTRAIN[k])
        _write_seq(root / "train" / "JPEGImages" / seq.name,
                   root / "train" / "Annotations" / seq.name, seq)
    return root


def test_occlusion_rules_equal_jax(rng):
    px = rng.randint(0, 3000, (70, 4)).astype(np.float64)
    px[5:9, 2] = 0
    for name in ("bus", "some-seq", "drone", "night-race", "classic-car", "bmx-bumps"):
        np.testing.assert_array_equal(td.davis_occlusion_rule(name, px, px.max(axis=0)),
                                      jd.davis_occlusion_rule(name, px, px.max(axis=0)))
    np.testing.assert_array_equal(td.ytvos_occlusion_rule("x", px, None),
                                  jd.ytvos_occlusion_rule("x", px, None))


def _same_tables(a, b):
    assert a.frame_names == b.frame_names
    assert sorted(a.occlusions) == sorted(b.occlusions)
    for k in a.occlusions:
        np.testing.assert_array_equal(a.occlusions[k], b.occlusions[k])


@pytest.mark.parametrize("seed", [0, 3])
def test_davis_specs_tables_and_frames_equal_jax(davis, seed):
    cache = davis / "davis_meta.npz"
    cache.unlink(missing_ok=True)
    np.random.seed(seed)
    want = jd.DAVISTrainingDataset(davis, epoch_repeats=3)          # writes the cache
    got = td.DAVISTrainingDataset(davis, epoch_repeats=3, rng=np.random.RandomState(seed),
                                  py_rng=random.Random(seed))      # reads it
    _same_tables(got.table, want.table)
    assert [s.encoded() for s in got.specs] == [s.encoded() for s in want.specs]
    assert len(got) == 9                                            # (1 + 2 objects) x 3
    assert got.table.trackable_objects("seq1") == [1, 2]
    assert set(got.table.visible_frames("seq1", 2)) == {0, 1, 4, 5}
    for i in range(len(got)):
        (gi, gl, ge), (wi, wl, we) = got[i], want[i]
        assert ge == we
        for a, b, c, d in zip(gi, wi, gl, wl):
            assert a.shape == (480, 854, 3) and c.shape == (480, 854, 1)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, d)
        assert gl[0].sum() > 0          # the object is present in its first frame
    # and the JAX package reads the port's cache
    cache.unlink()
    td.DAVISTrainingDataset(davis, epoch_repeats=1, rng=np.random.RandomState(0))
    _same_tables(jd.DAVISTrainingDataset(davis, epoch_repeats=1).table, got.table)


def test_ytvos_specs_and_frames_equal_jax(ytvos):
    """The tree holds 3 of the 2944 jjtrain sequences. The port counts the
    others as sequences of no frames; frtm_tpu fails to scan such a tree, but
    reads the port's cache of it and then draws the same specs."""
    (ytvos / "ytvos2018_meta.npz").unlink(missing_ok=True)
    got = td.YouTubeVOSTrainingDataset(ytvos, epoch_samples=4, rng=np.random.RandomState(4),
                                       py_rng=random.Random(4))
    assert len(got.table.occlusions) == len(JJTRAIN)
    assert sum(got.table.length(s) > 0 for s in JJTRAIN) == 3
    random.seed(4)
    np.random.seed(4)
    want = jd.YouTubeVOSTrainingDataset(ytvos, epoch_samples=4)
    _same_tables(got.table, want.table)
    assert len(got) == 4                # 4 of the 6 (sequence, object) candidates
    assert [s.encoded() for s in got.specs] == [s.encoded() for s in want.specs]
    cubic = 0
    for i in range(len(got)):
        (gi, gl, _), (wi, wl, _) = got[i], want[i]
        spec = td.SampleSpec.from_encoded([got[i][2]])[0]
        for a, b, c, d in zip(gi, wi, gl, wl):
            np.testing.assert_array_equal(c, d)
            if spec.seq_name == JJTRAIN[1]:       # 360x640: cubic, within one level
                gap = np.abs(a.astype(np.int64) - b)
                assert gap.max() <= 1 and gap.mean() < 5e-3
                cubic += 1
            else:                                 # 720x1280: area, bit-equal
                np.testing.assert_array_equal(a, b)
    assert 0 < cubic < 3 * len(got)


def test_synthetic_dataset_equals_jax():
    got = td.SyntheticTrainingDataset(n_samples=3, size=(48, 64), sample_size=3, seed=5)
    want = jd.SyntheticTrainingDataset(n_samples=3, size=(48, 64), sample_size=3, seed=5)
    for i in range(3):
        (gi, gl, ge), (wi, wl, we) = got[i], want[i]
        assert ge == we
        for a, b in zip(gi + gl, wi + wl):
            np.testing.assert_array_equal(a, b)
