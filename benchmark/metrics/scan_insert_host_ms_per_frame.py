"""The thread-CPU time of the port's `scan_insert` spans in ms over the
tracked frames (every frame but the first): the host's cost of issuing
a window's gather of the merged rows, the >= 10 pixel gate and the per-frame memory inserts. One of the scan's four steps; the four sum to about the `scan`
phase's own thread-CPU time, without the closing synchronise that
scan_host_ms_per_frame holds."""
from benchmark.metrics._program import per_unit_ms, tracked_frames


def read(context):
    return per_unit_ms(context, "scan_insert", tracked_frames(context), cpu=True)
