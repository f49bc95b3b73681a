"""The share of the window's filter re-solves that a CUDA graph served: 100
x the port's `resolve_replays` counter (one a resolve_due call a replay
served, 0 one run eagerly) over its `resolves` counter (one a resolve_due
call in the scan), over the window's sequences. A port that does not count
replays reads as nothing."""
from benchmark.metrics._program import recorder, window


def read(context):
    got = window(context)
    if got is None:
        return None
    counts = recorder().counts(got[1])
    if "resolve_replays" not in counts or not counts.get("resolves"):
        return None
    return 100.0 * counts["resolve_replays"] / counts["resolves"]
