"""The tracker's "scan" phase (the loop over windows: classify, decode,
merge, memory inserts, re-solves), synchronised at its edges, in ms over the
tracked frames (every frame but the first)."""
from benchmark.metrics._phases import per_unit_ms


def read(context):
    return per_unit_ms(context, "scan", lambda r: r["frames"] - 1)
