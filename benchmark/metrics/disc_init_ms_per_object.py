"""The "disc_init" phase (the backbone pass over the augmented frames and
the two-phase GN-CG init of all objects), synchronised, in ms an object."""
from benchmark.metrics._phases import per_unit_ms


def read(context):
    return per_unit_ms(context, "disc_init", lambda r: r["objects"])
