"""Dataset-level scoring (frtm_tpu/eval/evaluation.py).

Scores every sequence of a dataset against predicted label PNGs and emits the
challenge-style console and text report (running dataset mean, per-object and
per-frame sparklines). The report's format is part of the surface, letter for
letter: downstream tooling greps it.
"""
from pathlib import Path

import numpy as np

from ..data.image import imread
from ..utils.meters import text_bargraph
from .davis import evaluate_sequence, mean, nanmean


class _Report:
    """Tees report lines to stdout and (optionally) a text file."""

    def __init__(self, path):
        self._file = open(path, "w") if path is not None else None

    def line(self, msg):
        print(msg)
        if self._file is not None:
            self._file.write(msg + "\n")
            self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()


def _load_frames(sequence, results_path):
    """Read ground-truth and predicted label images for every annotated frame.

    Returns ({frame: gt_labels}, {frame: predicted_labels}). When the dataset
    merges objects (DAVIS 2016 protocol) the ground truth collapses to a
    single binary object."""
    gt, pred = {}, {}
    for file in sequence.annos:
        labels = imread(file)
        if sequence.merge_objects:
            labels = (labels != 0).astype(np.uint8)
        gt[file.stem] = labels
        pred[file.stem] = imread(Path(results_path) / sequence.name / file.name)
    return gt, pred


def _first_frame_of_objects(sequence):
    """Invert the sequence's {start_frame: [obj_ids]} map to {obj_id: frame},
    validating that each object starts exactly once and none is background."""
    first = {}
    for obj_id in sequence.obj_ids:
        starts = [f for f, ids in sequence.start_frames.items() if obj_id in ids]
        assert len(starts) <= 1, (sequence.name, obj_id, starts)
        if starts:  # objects without a start frame are not scored
            first[obj_id] = starts[0]
    assert 0 not in first, "background cannot be a tracked object"
    return first


def evaluate_dataset(dset, results_path, measure="J", to_file=True):
    """Evaluate all sequences of `dset` against label PNGs under
    `results_path/<sequence>/`. Returns the dataset mean score."""
    results_path = Path(results_path)
    report = _Report(results_path / f"evaluation-{measure}.txt" if to_file else None)

    all_object_scores = []   # one entry per (sequence, object)
    all_decay, all_recall = [], []

    n_seqs = len(dset)
    for seq_idx, sequence in enumerate(dset, start=1):
        gt, pred = _load_frames(sequence, results_path)
        first_frames = _first_frame_of_objects(sequence)

        plural = "s" if len(first_frames) > 1 else ""
        report.line(f"{seq_idx}/{n_seqs}: {sequence.name}: "
                    f"{len(first_frames)} object{plural}")

        scored = evaluate_sequence(pred, gt, first_frames, measure=measure)
        per_frame = list(scored["raw"].values())    # [(n_frames,)] per object
        per_object = [mean(s) for s in per_frame]

        if len(first_frames) > 1:
            for obj_id, frame_scores, obj_score in zip(
                    scored["raw"], per_frame, per_object):
                report.line("joint {obj}: acc {score:.3f} ┊{apf}┊".format(
                    obj=obj_id, score=obj_score,
                    apf=text_bargraph(frame_scores)))

        all_object_scores.extend(per_object)
        all_decay.extend(scored["decay"])
        all_recall.extend(scored["recall"])

        # sequence line: object-mean score, running dataset mean, and the
        # object-averaged per-frame score curve (a sequence with no scored
        # objects gets a NaN curve rather than crashing np.stack on [])
        frame_curve = (nanmean(np.stack(per_frame), axis=0) if per_frame
                       else np.full(1, np.nan))
        report.line("final  : acc {seq:.3f} ({dset:.3f}) ┊{apf}┊".format(
            seq=mean(per_object), dset=np.mean(all_object_scores),
            apf=text_bargraph(frame_curve)))

    dataset_score = mean(all_object_scores)
    report.line("%s: %.3f, recall: %.3f, decay: %.3f" % (
        measure, dataset_score, mean(all_recall), mean(all_decay)))
    report.close()
    return float(dataset_score)
