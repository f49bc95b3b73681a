"""Training datasets (frtm_tpu/data/training_datasets.py): random samples of
one first frame and two train frames from DAVIS 2017 train and YouTube-VOS
2018 jjtrain, drawn where the object is visible, at 480x854.

The same pieces as the JAX package: `SampleSpec` (JSON-encodable sample
descriptors); per-frame label pixel counts turned into occlusion matrices by
a dataset's rule (the DAVIS rule's hand-tuned per-sequence data verbatim),
cached by `VisibilityTable` as `{name}_meta.npz` beside the dataset root in
the JAX package's format, so that either package reads the other's cache;
per-epoch resampling (DAVIS: every object x repeats; YouTube-VOS: a random
subset of (sequence, object) pairs), keeping the reference's quirk of
drawing `size` frames and discarding the first; frames resized to 480x854
by the port's cv2-free resizers (data/resize_host.py: area or cubic for
images, nearest for labels) and the chosen object relabelled 1; and a
data-free `SyntheticTrainingDataset`.

Randomness comes from explicit generators, an np.random.RandomState and a
random.Random, where the JAX package draws from the global ones: seeded
alike, both packages draw the same specs. Frames are read with the port's
own decoders (data/image.py).
"""
import json
import random
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from .image import imread
from .resize_host import resize_area, resize_cubic, resize_nearest
from .synthetic import make_moving_square_sequence

FRAME_SIZE = (480, 854)


@dataclass
class SampleSpec:
    """One training sample: sequence, object, [frame0, frame1, frame2]."""
    seq_name: Optional[str] = None
    obj_id: Optional[int] = None
    frames: Optional[List[int]] = None
    frame0_id: Optional[int] = None

    def encoded(self):
        return json.dumps(asdict(self))

    @staticmethod
    def from_encoded(meta):
        return [SampleSpec(**json.loads(m)) for m in meta]


# -- occlusion metadata --------------------------------------------------------

def _scan_label_stats(anno_path, sequences):
    """Per-sequence (pixel-count matrix, per-object max) from the label PNGs.
    The matrix is (n_frames, max_obj_id + 1); column 0 is the background.
    A listed sequence without label files counts as one of no frames, which
    no sampling takes (the JAX package fails on such a tree instead; with
    this, a tree that holds part of a split list trains on that part, and
    its cache reads in either package)."""
    frame_names, pixel_counts = {}, {}
    for seq in sorted(sequences):
        files = sorted((Path(anno_path) / seq).glob("*.png"))
        stats = [np.unique(imread(f)[..., 0], return_counts=True) for f in files]
        n_objects = max((int(ids.max()) for ids, _ in stats), default=0)
        px = np.zeros((len(files), n_objects + 1))
        for row, (ids, counts) in zip(px, stats):
            row[ids] = counts
        frame_names[seq] = [f.stem for f in files]
        pixel_counts[seq] = (px, px.max(axis=0, initial=0))
    return frame_names, pixel_counts


# DAVIS hand-tuned occlusion data (reference lib/training_datasets.py:211-262)
_DAVIS_MIN_PX = 100
_DAVIS_NEVER_OCCLUDED = frozenset({
    "bus", "car-turn", "drift-turn", "kid-football", "koala", "mallard-fly",
    "motocross-bumps", "motorbike", "rallye", "snowboard", "train",
    "upside-down"})
_DAVIS_THRESHOLDS = {
    "bmx-bumps": 0.5, "disk-jockey": 0.5,
    "boxing-fisheye": 0.2, "cat-girl": 0.2, "dog-gooses": 0.2,
    "tractor-sand": 0.1, "drone": 0.1}


def davis_occlusion_rule(seq_name, px_counts, max_counts):
    """(n_frames, n_objects+1) boolean occlusion matrix for one DAVIS
    sequence, with the hand-tuned thresholds and per-sequence overrides."""
    if seq_name in _DAVIS_NEVER_OCCLUDED:
        occ = np.zeros(px_counts.shape, bool)
    else:
        thr = _DAVIS_THRESHOLDS.get(seq_name, 0.25)
        occ = (px_counts / (max_counts + 0.001)) < thr
        occ |= max_counts == 0

    if seq_name == "classic-car":
        occ[:56, :] = False
    elif seq_name == "drone":
        occ[:17, 1] = False      # red quad
        occ[24:60, 1] = False
    elif seq_name == "night-race":
        occ[:29, :] = False
        occ[:, 2] = False        # green car

    return occ | (px_counts < _DAVIS_MIN_PX)


def ytvos_occlusion_rule(seq_name, px_counts, max_counts):
    """YouTube-VOS rule: under 100 labelled pixels = occluded."""
    return px_counts < 100


class VisibilityTable:
    """Cached per-(sequence, frame, object) visibility, derived from label
    pixel counts by a dataset's occlusion rule; the cache is
    `{name}_meta.npz` beside the dataset root."""

    def __init__(self, name, dset_path, anno_path, sequences, rule):
        self._cache_file = Path(dset_path) / (name + "_meta.npz")
        if self._cache_file.exists():
            # a file this package or the JAX package wrote: dicts of names
            # and boolean arrays, stored as numpy object arrays
            with np.load(self._cache_file, allow_pickle=True) as z:
                self.frame_names = z["frame_names"].item()
                self.occlusions = z["occlusions"].item()
            return
        print("Caching occlusions for %s, please wait." % anno_path)
        self.frame_names, stats = _scan_label_stats(anno_path, sequences)
        self.occlusions = {seq: rule(seq, px, mx) for seq, (px, mx) in stats.items()}
        np.savez(self._cache_file,
                 frame_names=np.array(self.frame_names, dtype=object),
                 occlusions=np.array(self.occlusions, dtype=object))

    def length(self, seq_name):
        return self.occlusions[seq_name].shape[0]

    def trackable_objects(self, seq_name):
        """Ids (excluding background 0) visible in at least one frame."""
        occ = np.asarray(self.occlusions[seq_name], bool)
        ever_visible = np.where(~occ.all(axis=0))[0]
        return [int(o) for o in ever_visible if o != 0]

    def visible_frames(self, seq_name, obj_id):
        """Frame indices where the object is visible."""
        occ = np.asarray(self.occlusions[seq_name], bool)
        return np.where(~occ[:, obj_id])[0]


# -- sampling -------------------------------------------------------------------

def draw_sample_spec(table: VisibilityTable, seq_name, obj_id, rng: np.random.RandomState,
                     size=3):
    """Random sample: frame0 uniformly over the visible frames, then `size`
    draws without replacement over the other frames, of which the FIRST is
    discarded (the reference's quirk, kept so frame statistics match)."""
    first = int(rng.choice(table.visible_frames(seq_name, obj_id)))
    rest = np.arange(table.length(seq_name))
    rest = rest[rest != first]
    drawn = rng.choice(rest, size=size, replace=False).tolist()
    return SampleSpec(seq_name, obj_id, frames=[first, *drawn[1:]], frame0_id=first)


def build_epoch_specs(table, sequences, epoch_samples, epoch_repeats, min_seq_length,
                      sample_size, rng: np.random.RandomState, py_rng: random.Random):
    """One epoch's SampleSpecs: every (sequence, object) candidate, or a
    random subset of epoch_samples of them, times epoch_repeats draws."""
    candidates = [(seq, obj)
                  for seq in sequences
                  if table.length(seq) >= min_seq_length
                  for obj in table.trackable_objects(seq)]
    if epoch_samples > 0:
        candidates = py_rng.sample(candidates, min(epoch_samples, len(candidates)))
    return [draw_sample_spec(table, seq, obj, rng, size=sample_size)
            for seq, obj in candidates
            for _ in range(epoch_repeats)]


# -- frame loading ----------------------------------------------------------------

def _load_sample_frame(jpeg_path, anno_path, spec, frame_name, area_ok):
    """One (image (480, 854, 3), binary label (480, 854, 1)) pair. Images
    shrink by area averaging (DAVIS always takes it), otherwise enlarge by
    cubic interpolation; labels resize nearest and the chosen object becomes
    1."""
    im = imread(Path(jpeg_path) / spec.seq_name / (frame_name + ".jpg"))
    shrinking = FRAME_SIZE[0] / im.shape[0] < 1.0
    im = (resize_area if (shrinking or area_ok) else resize_cubic)(im, FRAME_SIZE)
    lb = imread(Path(anno_path) / spec.seq_name / (frame_name + ".png"))[..., 0]
    lb = resize_nearest((lb == spec.obj_id).astype(np.uint8), FRAME_SIZE)
    return im, lb[..., None]


class _EpochSampleDataset:
    """A list of SampleSpecs drawn per epoch, read from disk per item."""

    def __init__(self, name, dset_path, jpeg_path, anno_path, sequences, rule,
                 epoch_samples, epoch_repeats, min_seq_length, sample_size, rng, py_rng):
        self.name = name
        self.dset_path = Path(dset_path)
        self.jpeg_path = jpeg_path
        self.anno_path = anno_path
        self.sequences = list(sequences)
        self.table = VisibilityTable(name, self.dset_path, anno_path, self.sequences, rule)
        self.specs = build_epoch_specs(
            self.table, self.sequences, epoch_samples, epoch_repeats, min_seq_length,
            sample_size, rng if rng is not None else np.random.RandomState(),
            py_rng if py_rng is not None else random.Random())

    def __len__(self):
        return len(self.specs)

    def __getitem__(self, item):
        spec = self.specs[item]
        names = self.table.frame_names[spec.seq_name]
        pairs = [_load_sample_frame(self.jpeg_path, self.anno_path, spec, names[f],
                                    area_ok=self.name == "davis")
                 for f in spec.frames]
        return [p[0] for p in pairs], [p[1] for p in pairs], spec.encoded()


class DAVISTrainingDataset(_EpochSampleDataset):
    """DAVIS 2017 train: `{root}/ImageSets/2017/train.txt`, 480p frames."""

    def __init__(self, dset_path, epoch_repeats=8, epoch_samples=0, min_seq_length=4,
                 sample_size=3, rng=None, py_rng=None):
        dset_path = Path(dset_path)
        with open(dset_path / "ImageSets/2017/train.txt") as f:
            sequences = [s.strip() for s in f]
        super().__init__(
            "davis", dset_path,
            jpeg_path=dset_path / "JPEGImages" / "480p",
            anno_path=dset_path / "Annotations" / "480p",
            sequences=sequences, rule=davis_occlusion_rule,
            epoch_samples=epoch_samples, epoch_repeats=epoch_repeats,
            min_seq_length=min_seq_length, sample_size=sample_size, rng=rng, py_rng=py_rng)


class YouTubeVOSTrainingDataset(_EpochSampleDataset):
    """YouTube-VOS train, the jjtrain split (data/ytvos_jjtrain.txt)."""

    def __init__(self, dset_path, epoch_samples=4000, epoch_repeats=1, min_seq_length=4,
                 sample_size=3, year=2018, rng=None, py_rng=None):
        dset_path = Path(dset_path)
        with open(Path(__file__).parent / "ytvos_jjtrain.txt") as f:
            sequences = [s.strip() for s in f]
        super().__init__(
            "ytvos" + str(year), dset_path,
            jpeg_path=dset_path / "train" / "JPEGImages",
            anno_path=dset_path / "train" / "Annotations",
            sequences=sequences, rule=ytvos_occlusion_rule,
            epoch_samples=epoch_samples, epoch_repeats=epoch_repeats,
            min_seq_length=min_seq_length, sample_size=sample_size, rng=rng, py_rng=py_rng)


class SyntheticTrainingDataset:
    """Data-free stand-in: moving-square samples with the training-dataset
    item interface (images, labels, encoded spec)."""

    def __init__(self, n_samples=16, size=(120, 160), sample_size=3, seed=0):
        self.samples = []
        for i in range(n_samples):
            # the seed is part of the name: the target-model cache is keyed by
            # sequence name, and differently seeded scenes are different data
            self.samples.append(make_moving_square_sequence(
                n_frames=sample_size, size=size, square=28, seed=seed + i,
                name=f"synth{seed + i:06d}"))
        self.sample_size = sample_size

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, item):
        seq = self.samples[item]
        images = [seq.images[t] for t in range(self.sample_size)]
        labels = [(seq.labels[t] == 1).astype(np.uint8) for t in range(self.sample_size)]
        spec = SampleSpec(seq.name, 1, frames=list(range(self.sample_size)), frame0_id=0)
        return images, labels, spec.encoded()
