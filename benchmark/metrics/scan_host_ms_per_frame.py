"""The "scan" phase's thread-CPU time in ms over the tracked frames: the
host's cost of issuing the loop's launches. Near scan_ms_per_frame, the host
sets the pace."""
from benchmark.metrics._phases import per_unit_ms


def read(context):
    return per_unit_ms(context, "scan", lambda r: r["frames"] - 1, cpu=True)
