"""The port's DAVIS measures (frtm_tpu_torch/eval) against frtm_tpu.eval on
seeded random masks: J, F, seg2bmap, mean, recall, decay, std and
evaluate_sequence equal to 1e-12 (both are numpy and scipy.ndimage, so the
measured difference is 0), and evaluate_dataset's report equal line for
line: downstream tooling greps it."""
import numpy as np
import pytest

from frtm_tpu.data.image import imwrite_indexed as jax_imwrite
from frtm_tpu.eval import davis as jd
from frtm_tpu.eval.evaluation import evaluate_dataset as jax_evaluate_dataset
from frtm_tpu_torch.data.image import imwrite_indexed
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
from frtm_tpu_torch.eval import davis as pd
from frtm_tpu_torch.eval.evaluation import evaluate_dataset


def _blobs(rng, h, w, p=0.5):
    """A random mask with structure: noise smoothed by a box and thresholded."""
    a = rng.rand(h + 6, w + 6)
    a = sum(a[dy:dy + h, dx:dx + w] for dy in range(7) for dx in range(7)) / 49
    return a > np.quantile(a, 1 - p)


MASKS = [(0, 37, 53, 0.5), (1, 48, 64, 0.2), (2, 30, 41, 0.9), (3, 480, 854, 0.4)]


@pytest.mark.parametrize("seed,h,w,p", MASKS)
def test_j_and_f_match_jax(seed, h, w, p):
    rng = np.random.RandomState(seed)
    fg, gt = _blobs(rng, h, w, p), _blobs(rng, h, w, p)
    for a, b in ((fg, gt), (fg, fg), (fg, np.zeros_like(gt)), (np.zeros_like(fg), gt),
                 (np.zeros_like(fg), np.zeros_like(gt))):
        for mine, theirs in ((pd.davis_jaccard_measure, jd.davis_jaccard_measure),
                             (pd.davis_f_measure, jd.davis_f_measure)):
            got, want = mine(a, b), theirs(a, b)
            assert np.isnan(got) == np.isnan(want)
            if not np.isnan(want):
                assert abs(got - want) <= 1e-12
    assert 0 < pd.davis_jaccard_measure(fg, gt) < 1 and 0 < pd.davis_f_measure(fg, gt) < 1


@pytest.mark.parametrize("seed,h,w,p", MASKS[:3])
def test_seg2bmap_matches_jax(seed, h, w, p):
    seg = _blobs(np.random.RandomState(seed), h, w, p)
    np.testing.assert_array_equal(pd.seg2bmap(seg), jd.seg2bmap(seg))
    assert pd.seg2bmap(seg).any()
    for bmap in (pd.seg2bmap, jd.seg2bmap):     # the toolkit's guard on the output size
        with pytest.raises(AssertionError, match="Cannot convert"):
            bmap(seg, w // 3, h)


@pytest.mark.parametrize("n", [1, 4, 7, 40, 300])
def test_statistics_match_jax(n):
    x = np.random.RandomState(n).rand(n)
    x[::5] = np.nan
    for name in ("mean", "recall", "decay", "std"):
        got, want = getattr(pd, name)(x), getattr(jd, name)(x)
        assert np.isnan(got) == np.isnan(want), name
        if not np.isnan(want):
            assert abs(got - want) <= 1e-12, name
    np.testing.assert_equal(pd.recall(x, 0.9), jd.recall(x, 0.9))      # NaN where all are NaN


@pytest.mark.parametrize("measure", ["J", "F"])
def test_evaluate_sequence_matches_jax(measure):
    rng = np.random.RandomState(5)
    frames = [f"{i:05d}" for i in range(7)]
    gt, pred = {}, {}
    for f in frames:
        a, b = _blobs(rng, 40, 56, 0.3), _blobs(rng, 40, 56, 0.3)
        gt[f] = (a + 2 * (b & ~a)).astype(np.uint8)[..., None]
        pred[f] = np.roll(gt[f], rng.randint(-3, 4), axis=1)
    info = {1: frames[0], 2: frames[2]}        # object 2 enters at frame 2
    got = pd.evaluate_sequence(pred, gt, info, measure=measure)
    want = jd.evaluate_sequence(pred, gt, info, measure=measure)
    assert set(got) == set(want)
    for key in want:
        if key == "raw":
            assert list(got["raw"]) == list(want["raw"])
            for k in want["raw"]:
                np.testing.assert_allclose(got["raw"][k], want["raw"][k], rtol=0, atol=1e-12)
        else:
            np.testing.assert_allclose(np.asarray(got[key], float), np.asarray(want[key], float),
                                       rtol=0, atol=1e-12)


class _EvalDataset:
    """The interface evaluate_dataset reads of a dataset and its sequences."""

    def __init__(self, seqs, anno_root, write):
        self._seqs = []
        for seq in seqs:
            d = anno_root / seq.name
            d.mkdir(parents=True, exist_ok=True)
            seq.annos = []
            for f, lb in zip(seq.frame_names, seq.labels):
                write(d / (f + ".png"), lb)
                seq.annos.append(d / (f + ".png"))
            self._seqs.append(seq)
        self.name = "synthval"

    def __len__(self):
        return len(self._seqs)

    def __getitem__(self, i):
        return self._seqs[i]


@pytest.mark.parametrize("measure", ["J", "F"])
def test_evaluate_dataset_report_is_the_jax_package_s_line_for_line(tmp_path, capsys, measure):
    """One, two and three objects; predictions shifted by a different amount
    per frame, so the sparklines hold several glyphs; one package's PNGs
    scored by the other."""
    def seqs():
        return [make_moving_square_sequence(n_frames=7, size=(48, 64), square=14, n_objects=n,
                                            seed=n, name=f"seq{n}") for n in (1, 2, 3)]
    port = _EvalDataset(seqs(), tmp_path / "annos_port", imwrite_indexed)
    jax_ = _EvalDataset(seqs(), tmp_path / "annos_jax", jax_imwrite)
    for root, write in ((tmp_path / "res_port", imwrite_indexed), (tmp_path / "res_jax", jax_imwrite)):
        for seq in seqs():
            (root / seq.name).mkdir(parents=True)
            for i, (f, lb) in enumerate(zip(seq.frame_names, seq.labels)):
                write(root / seq.name / (f + ".png"), np.roll(lb, i % 4, axis=1))
    got = evaluate_dataset(port, tmp_path / "res_jax", measure=measure)
    out_port = capsys.readouterr().out
    want = jax_evaluate_dataset(jax_, tmp_path / "res_port", measure=measure)
    out_jax = capsys.readouterr().out
    assert abs(got - want) <= 1e-12 and 0.3 < got < 1.0
    a = (tmp_path / "res_jax" / f"evaluation-{measure}.txt").read_text()
    b = (tmp_path / "res_port" / f"evaluation-{measure}.txt").read_text()
    assert a.splitlines() == b.splitlines() and a == out_port == out_jax
    lines = a.splitlines()
    assert lines[0] == "1/3: seq1: 1 object" and "2/3: seq2: 2 objects" in lines
    assert any(ln.startswith("joint 2: acc ") for ln in lines)
    assert lines[-1].startswith(f"{measure}: {got:.3f}, recall: ")
    assert evaluate_dataset(port, tmp_path / "res_jax", measure=measure, to_file=False) == got
