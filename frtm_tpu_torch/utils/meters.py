"""Console metering (frtm_tpu/utils/meters.py): running averages that ignore
NaNs, and the unicode sparkline of the evaluation reports."""
import math

import numpy as np


class AverageMeter:
    """Running average over scalar (or batched) updates, skipping NaNs.

    Exposes `val` (most recent update) and `avg` (running mean over all
    non-NaN values seen since the last reset).
    """

    def __init__(self):
        self._total = 0.0
        self._n = 0
        self.val = 0.0

    def reset(self):
        self.__init__()

    @property
    def sum(self):
        return self._total

    @property
    def count(self):
        return self._n

    @property
    def avg(self):
        return self._total / self._n if self._n else 0.0

    def update(self, val, n=1):
        if math.isnan(val):
            return
        self.val = val
        self._total += val * n
        self._n += n

    def update_multi(self, vals):
        vals = np.asarray(vals, dtype=np.float64)
        self.val = vals
        finite = vals[~np.isnan(vals)]
        self._total += float(finite.sum())
        self._n += finite.size


# 9 fill levels: round(v * 8) picks the glyph for v in [0, 1]
_BAR_LEVELS = " ▁▂▃▄▅▆▇█"


def _bar_cell(v):
    if math.isnan(v):
        return "░"
    if v < 0:
        return "u"
    if v > 1:
        return "o"
    return _BAR_LEVELS[int(v * 8 + 0.5)]


def text_bargraph(values):
    """Unicode sparkline of values in [0, 1]. NaN renders as a shaded block,
    below-range as 'u' and above-range as 'o' markers."""
    return "".join(_bar_cell(float(v)) for v in np.ravel(values))
