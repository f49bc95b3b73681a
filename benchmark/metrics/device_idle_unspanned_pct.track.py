"""The share of the device's idle time in the profiled sub-window (as
device_idle_pct.track takes it: outside the union of the profiler's device
intervals) during which the issuing thread had none of the port's spans
open below its entry points (run_dataset, run_sequence), in percent: the
entry points' self time and the time outside every span, which the port's
spans leave unnamed."""
from benchmark.harness.track import _union
from benchmark.metrics._program import recorder, window

ENTRY_POINTS = ("run_dataset", "run_sequence")


def _length(merged):
    return sum(e - s for s, e in merged)


def _overlap(a, b):
    """The length of the intersection of two sorted, merged interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(context):
    if "trace_window" not in context:
        return None
    got = window(context)
    if got is None:
        return None
    t0, t1 = context["trace_window"]
    thread = got[2]
    busy = _union(context["device_intervals"], t0, t1)
    idle = (t1 - t0) - _length(busy)
    if idle <= 0:
        return None
    named = _union(sorted(((s.name, s.start_ns, s.end_ns) for s in recorder().spans()
                           if s.end_ns is not None and s.thread == thread
                           and s.name not in ENTRY_POINTS), key=lambda v: v[1]), t0, t1)
    named_idle = _length(named) - _overlap(named, busy)
    return 100.0 * (idle - named_idle) / idle
