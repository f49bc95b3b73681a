"""The wall time of the port's `png_write` spans (run_dataset writing a
sequence's indexed label PNGs on its loop's thread) in ms over the frames
written."""
from benchmark.metrics._program import per_unit_ms


def read(context):
    return per_unit_ms(context, "png_write", sum(r["frames"] for r in context["records"]))
