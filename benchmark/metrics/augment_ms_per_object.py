"""The first-frame augment inside the timed region (host cut and Telea
inpaint, kernel 3's warps), synchronised, in ms an object. A pipelined run
augments on its prefetch thread, outside run_sequence: nothing to read."""
from benchmark.metrics._phases import per_unit_ms


def read(context):
    return per_unit_ms(context, "augment", lambda r: r["objects"])
