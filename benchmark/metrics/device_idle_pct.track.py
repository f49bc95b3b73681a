"""The share of the profiled sub-window that no kernel, copy or set covers,
from the union of the profiler's device intervals (overlaps count once), in
percent. A record the profiler drops reads as idle; the run prints how many
it kept."""
from benchmark.harness.track import busy_seconds


def read(context):
    if "trace_window" not in context:
        return None
    t0, t1 = context["trace_window"]
    if t1 <= t0:
        return None
    return 100.0 * (1.0 - busy_seconds(context["device_intervals"], t0, t1) / ((t1 - t0) / 1e9))
