"""The "extract" phase (the whole-sequence backbone pass), synchronised, in
ms over the tracked frames it extracts."""
from benchmark.metrics._phases import per_unit_ms


def read(context):
    return per_unit_ms(context, "extract", lambda r: r["frames"] - 1)
