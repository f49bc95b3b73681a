"""DAVIS evaluation measures (frtm_tpu/eval/davis.py): region similarity J
(Jaccard) and boundary accuracy F, with the challenge toolkit's statistics
(mean, recall, decay, std). numpy and scipy.ndimage only.

The metric definitions originate in the DAVIS challenge toolkit (Copyright
(c) 2017 Federico Perazzi, BSD license; `seg2bmap` from David Martin's BSDS
code, January 2003). Boundary maps are neighbour-difference planes, the disk
structuring element is built directly and the dilation runs through
scipy.ndimage, which matches skimage.morphology.binary_dilation. As in the
JAX package, two latent toolkit bugs are fixed, with no effect on any path
that is reached: `decay` indexes its bins with int64 (the toolkit's uint8
overflowed beyond 255 scored frames), and `seg2bmap`'s resize branch has its
guard's precedence and its column scale corrected.
"""
import warnings
from collections import OrderedDict
from math import floor

import numpy as np
from scipy import ndimage


# -- per-sequence scoring -----------------------------------------------------

def evaluate_sequence(segmentations, annotations, object_info, measure="J"):
    """Score one sequence per object.

    Toolkit protocol (db_eval_sequence): a frame is scored for an object only
    strictly after the object's first frame and strictly before the
    sequence's last frame; all other frames are NaN.

    :param segmentations: {frame_name: (H, W[,1]) predicted label image}
    :param annotations:   {frame_name: (H, W[,1]) ground-truth label image}
    :param object_info:   {object_id: first_frame_name}
    :param measure:       'J' | 'F'
    :return: dict(raw={obj: per-frame scores}, mean/recall/decay/std=[per obj])
    """
    score_fn = {"J": davis_jaccard_measure, "F": davis_f_measure}[measure]
    frames = list(annotations.keys())
    last = len(frames) - 1

    raw = OrderedDict()
    for obj_id, first_frame in object_info.items():
        first = frames.index(first_frame)
        scores = np.full(len(frames), np.nan)
        for i in range(first + 1, last):
            gt_mask = np.asarray(annotations[frames[i]]).squeeze() == obj_id
            pred_mask = np.asarray(segmentations[frames[i]]).squeeze() == obj_id
            scores[i] = score_fn(pred_mask, gt_mask)
        raw[obj_id] = scores

    out = dict(raw=raw)
    for name, stat in (("decay", decay), ("mean", mean),
                       ("recall", recall), ("std", std)):
        out[name] = [float(stat(s)) for s in raw.values()]
    return out


# -- region similarity J -----------------------------------------------------

def davis_jaccard_measure(fg_mask, gt_mask):
    """Region similarity: intersection over union of binary masks; both-empty
    counts as a perfect 1 (toolkit db_eval_iou)."""
    gt_mask = np.asarray(gt_mask, bool)
    fg_mask = np.asarray(fg_mask, bool)
    union = np.sum(gt_mask | fg_mask, dtype=np.float32)
    if union == 0:
        return 1.0
    return np.sum(gt_mask & fg_mask) / union


# -- boundary accuracy F -----------------------------------------------------

def _disk(radius):
    """Circular structuring element matching skimage.morphology.disk."""
    r = int(radius)
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    return (x ** 2 + y ** 2) <= r ** 2


def davis_f_measure(foreground_mask, gt_mask, bound_th=0.008):
    """Boundary F-measure via morphological boundary matching (toolkit
    db_eval_boundary): precision/recall of the two boundary maps matched
    within radius ceil(bound_th * image diagonal)."""
    foreground_mask = np.asarray(foreground_mask).squeeze()
    gt_mask = np.asarray(gt_mask).squeeze()
    bound_pix = bound_th if bound_th >= 1 else \
        np.ceil(bound_th * np.linalg.norm(foreground_mask.shape))

    fg_boundary = seg2bmap(foreground_mask)
    gt_boundary = seg2bmap(gt_mask)
    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()

    # Degenerate cases, collapsed from the toolkit's four-way split:
    # both boundaries empty => P = R = 1 => F = 1; exactly one empty =>
    # one of P/R is 0 => F = 0.
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0

    selem = _disk(bound_pix)
    precision = (fg_boundary & ndimage.binary_dilation(gt_boundary, selem)).sum() / float(n_fg)
    recall_ = (gt_boundary & ndimage.binary_dilation(fg_boundary, selem)).sum() / float(n_gt)
    if precision + recall_ == 0:
        return 0.0
    return 2 * precision * recall_ / (precision + recall_)


def seg2bmap(seg, width=None, height=None):
    """Binary boundary map with 1-pixel-wide boundaries offset half a pixel
    toward the origin (David Martin's convention, as used by the toolkit).

    A pixel is boundary iff it differs from its east, south, or southeast
    neighbor — except on the last row (east differences only) and last column
    (south differences only); the bottom-right corner is never boundary.
    """
    seg = np.asarray(seg, bool)
    assert np.atleast_3d(seg).shape[2] == 1
    h, w = seg.shape[:2]
    width = w if width is None else width
    height = h if height is None else height

    # toolkit guard, with its precedence bug fixed (see module docstring)
    assert width <= w and height <= h and \
        abs(width / height - w / h) <= 0.01, \
        "Cannot convert %dx%d seg to %dx%d bmap." % (w, h, width, height)

    east = np.zeros_like(seg)
    south = np.zeros_like(seg)
    southeast = np.zeros_like(seg)
    east[:, :-1] = seg[:, :-1] != seg[:, 1:]
    south[:-1, :] = seg[:-1, :] != seg[1:, :]
    southeast[:-1, :-1] = seg[:-1, :-1] != seg[1:, 1:]

    b = east | south | southeast
    b[-1, :] = east[-1, :]
    b[:, -1] = south[:, -1]

    if (w, h) == (width, height):
        return b
    # downscale branch: never taken here (always called at equal size),
    # kept as the toolkit has it, with the `width / h` typo fixed
    bmap = np.zeros((height, width), bool)
    ys, xs = np.nonzero(b)
    for y, x in zip(ys, xs):
        j = 1 + floor((y - 1) + height / h)
        i = 1 + floor((x - 1) + width / w)
        bmap[j, i] = True
    return bmap


# -- per-object statistics ---------------------------------------------------

def nanmean(*args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        return np.nanmean(*args, **kwargs)


def mean(X):
    return nanmean(X)


def recall(X, threshold=0.5):
    """Fraction of (non-NaN) scores above the threshold."""
    x = np.asarray(X, dtype=np.float64)
    x = x[~np.isnan(x)]
    return nanmean(x > threshold)


def decay(X, n_bins=4):
    """Performance drop from the first to the last quarter of the sequence:
    mean(first bin) - mean(last bin) over the toolkit's overlapping-endpoint
    binning. Bin indices are int64 (the toolkit's uint8 cast overflowed for
    >255 scored frames; see module docstring)."""
    x = np.asarray(X, dtype=np.float64)
    x = x[~np.isnan(x)]
    edges = (np.round(np.linspace(1, len(x), n_bins + 1) + 1e-10) - 1).astype(np.int64)
    first_bin = x[edges[0]:edges[1] + 1]
    last_bin = x[edges[n_bins - 1]:edges[n_bins] + 1]
    return nanmean(first_bin) - nanmean(last_bin)


def std(X):
    return np.nanstd(X)
