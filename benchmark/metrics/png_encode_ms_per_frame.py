"""The wall time of the port's `png_encode` spans (a label writer thread
encoding and writing its part of a sequence's indexed label PNGs while
run_dataset's loop goes on) in ms over the frames written: the PNG work,
still done in full, off the loop's thread."""
from benchmark.metrics._program import per_unit_ms


def read(context):
    return per_unit_ms(context, "png_encode", sum(r["frames"] for r in context["records"]))
