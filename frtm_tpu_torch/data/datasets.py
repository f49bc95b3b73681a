"""Inference datasets (frtm_tpu/data/datasets.py): file-backed sequences for
DAVIS and YouTubeVOS.

A sequence yields (image, start_labels, new_object_ids) per frame, with
start-frame metadata, label suppression for objects before their start frame,
DAVIS 2016 object merging, optional preloading, and restart / sequence-subset
selection. Each dataset is a thin adapter that resolves its on-disk layout
into `SequenceDescriptor`s, and `FileSequence` is the one reader over a
descriptor. The YouTubeVOS jj splits read the split lists beside this module
(ytvos_jjtrain.txt, ytvos_jjvalid.txt: data, the port's own copies).
"""
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np

from .image import imread


# -- sequence descriptor + reader --------------------------------------------

@dataclass
class SequenceDescriptor:
    """Everything needed to read one video sequence from disk."""
    dataset: str                      # dataset display name, e.g. 'dv2017val'
    name: str                         # sequence name
    image_dir: Path                   # directory of *.jpg frames
    anno_dir: Path                    # directory of *.png label images
    object_starts: Dict[int, str]     # object id -> first frame name
    merge_objects: bool = False       # DAVIS 2016: collapse all objects to 1
    with_annotations: bool = False    # expose ground-truth annotation files

    def open(self):
        return FileSequence(self)


class FileSequence:
    """Reader over a SequenceDescriptor: jpeg frames + start-label pngs."""

    def __init__(self, descriptor: SequenceDescriptor):
        d = descriptor
        self.descriptor = d
        self.dset_name = d.dataset
        self.name = d.name
        self.anno_path = Path(d.anno_dir)
        self.merge_objects = d.merge_objects
        self.images = sorted(Path(d.image_dir).glob("*.jpg"))
        self.frame_names = [f.stem for f in self.images]
        self.preloaded = None

        # frame name -> object ids entering at that frame
        by_frame: Dict[str, list] = {}
        for obj_id, frame in d.object_starts.items():
            by_frame.setdefault(frame, []).append(obj_id)
        self.start_frames = by_frame
        self.obj_ids = [1] if d.merge_objects else list(d.object_starts.keys())

        if d.with_annotations:
            self.annos = sorted(self.anno_path.glob("*.png"))

    def __len__(self):
        return len(self.images)

    def __repr__(self):
        return "%s: %s, %d frames" % (self.dset_name, self.name, len(self))

    def preload(self):
        """Read every frame up front, to host memory (imread_batch: same-size
        JPEG frames on the host library's threads); the tracker uploads
        them."""
        from .image import imread_batch
        frames = imread_batch(self.images)
        self.preloaded = [frames[i] for i in range(len(self.images))]

    def _read_start_labels(self, frame_name, entering):
        """Label image restricted to the objects entering at this frame:
        DAVIS 2016 collapses everything to object 1; otherwise labels of
        objects that start elsewhere are suppressed to background."""
        lb = imread(self.anno_path / (frame_name + ".png"))
        if self.merge_objects:
            return (lb != 0).astype(np.uint8), [1]
        keep = {0, *entering}
        drop = [o for o in np.unique(lb).tolist() if o not in keep]
        for o in drop:
            lb = np.where(lb == o, 0, lb).astype(lb.dtype)
        return lb, list(entering)

    def __getitem__(self, item):
        if self.preloaded is not None:
            im = self.preloaded[item]
        else:
            im = imread(self.images[item])
        entering = self.start_frames.get(self.frame_names[item], [])
        if not entering:
            return im, [], []
        lb, entering = self._read_start_labels(self.frame_names[item], entering)
        return im, lb, entering

    def annotations(self):
        return {f.stem: imread(f) for f in self.annos}


# -- shared dataset plumbing --------------------------------------------------

def _apply_selection(names, sequences=None, restart=None):
    """Restrict to an explicit subset and/or resume from a given sequence."""
    if sequences is not None:
        unknown = set(sequences) - set(names)
        assert not unknown, f"unknown sequences: {sorted(unknown)}"
        names = sorted(set(names) & set(sequences))
    if restart is not None:
        assert restart in names, restart
        names = names[names.index(restart):]
    return list(names)


class _DescriptorDataset:
    """Base: an ordered collection of SequenceDescriptors.

    `all_annotations` may be flipped after construction (the eval CLI runs
    tracking first, then re-iterates with annotations exposed for scoring,
    mirroring the reference's `dset.all_annotations = True`)."""

    def __init__(self, name, descriptors, all_annotations=False):
        self.name = name
        self._descriptors = list(descriptors)
        self.sequences = [d.name for d in self._descriptors]
        self.all_annotations = all_annotations

    def __len__(self):
        return len(self._descriptors)

    def __getitem__(self, item):
        from dataclasses import replace
        d = self._descriptors[item]
        if self.all_annotations and not d.with_annotations:
            d = replace(d, with_annotations=True)
        return d.open()

    @property
    def start_frames(self):
        """{sequence: {obj_id: first_frame_name}} (reference attribute)."""
        return {d.name: dict(d.object_starts) for d in self._descriptors}


# -- DAVIS ---------------------------------------------------------------------

def _davis_object_starts(anno_dir):
    """In DAVIS every object appears in frame 00000; the object ids are
    whatever non-zero labels that frame contains."""
    first = imread(Path(anno_dir) / "00000.png")
    return {int(o): "00000" for o in sorted(np.unique(first)) if o != 0}


class DAVISDataset(_DescriptorDataset):
    """DAVIS 2016/2017 layout: JPEGImages/480p, Annotations/480p, and
    ImageSets/<year>/<split>.txt naming the sequences."""

    def __init__(self, path, year: str, split: str, restart=None, sequences=None,
                 all_annotations=False):
        root = Path(path).expanduser().resolve()
        if not root.exists():
            raise FileNotFoundError(f"Dataset directory '{path}' not found.")
        imset = root / "ImageSets" / year / (split + ".txt")
        names = _apply_selection(sorted(s.strip() for s in open(imset)),
                                 sequences, restart)

        dset_name = f"dv{year}{split}"
        jpeg_root = root / "JPEGImages" / "480p"
        anno_root = root / "Annotations" / "480p"
        super().__init__(dset_name, (
            SequenceDescriptor(
                dataset=dset_name, name=seq,
                image_dir=jpeg_root / seq, anno_dir=anno_root / seq,
                object_starts=_davis_object_starts(anno_root / seq),
                merge_objects=(year == "2016"),
                with_annotations=all_annotations)
            for seq in names), all_annotations=all_annotations)
        self.year = year


# -- YouTubeVOS ----------------------------------------------------------------

def _ytvos_layout(root, split):
    """Resolve a YouTubeVOS split to (jpeg_root, anno_root, names, meta).

    The jj* splits are the Joakim Johnander train/valid partition of the
    train set (names vendored next to this module); other splits list the
    sequences present under their Annotations directory. *_all_frames splits
    read images from the all-frames JPEG dump but share the base split's
    annotations and meta.json."""
    all_frames = split.endswith("_all_frames")
    if split in ("train", "train_all_frames", "jjval", "jjval_all_frames"):
        base = "train"
        im_split = "train_all_frames" if all_frames else "train"
        jj = "ytvos_jjvalid.txt" if split.startswith("jjval") else "ytvos_jjtrain.txt"
        names = sorted(s.strip() for s in open(Path(__file__).parent / jj))
    else:  # test / valid (+_all_frames)
        base = split[:-len("_all_frames")] if all_frames else split
        im_split = split
        names = sorted(p.name for p in (root / base / "Annotations").glob("*")
                       if p.is_dir())
    meta = json.load(open(root / base / "meta.json"))["videos"]
    return root / im_split / "JPEGImages", root / base / "Annotations", names, meta


class YouTubeVOSDataset(_DescriptorDataset):
    """YouTubeVOS layout: per-split JPEGImages/Annotations directories with a
    meta.json recording each object's first frame."""

    def __init__(self, path, year: str, split: str, restart=None, sequences=None,
                 all_annotations=False):
        root = Path(path).expanduser().resolve()
        if not root.exists():
            raise FileNotFoundError(f"Dataset directory '{path}' not found.")
        jpeg_root, anno_root, names, meta = _ytvos_layout(root, split)
        names = _apply_selection(names, sequences, restart)

        dset_name = f"ytvos{year}{split}"
        super().__init__(dset_name, (
            SequenceDescriptor(
                dataset=dset_name, name=seq,
                image_dir=jpeg_root / seq, anno_dir=anno_root / seq,
                object_starts={int(o): v["frames"][0]
                               for o, v in meta[seq]["objects"].items()},
                with_annotations=all_annotations)
            for seq in names), all_annotations=all_annotations)
        self.year = year
        self.meta = meta
