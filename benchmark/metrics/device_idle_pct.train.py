"""The share of the profiled window steps (harness/train.py's PROFILED)
that no kernel, copy or set covers, from the union of the profiler's device
intervals (overlaps count once), in percent. The traced run synchronises at
the train step's phase edges, so its idle share holds those bubbles."""
from benchmark.harness.track import busy_seconds


def read(context):
    if "trace_window" not in context:
        return None
    t0, t1 = context["trace_window"]
    if t1 <= t0:
        return None
    return 100.0 * (1.0 - busy_seconds(context["device_intervals"], t0, t1) / ((t1 - t0) / 1e9))
