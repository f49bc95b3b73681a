"""The port's `resolves` counter (one a resolve_due call in the scan) over
the window's sequences, per tracked frame. A count: one seed's runs read
the same."""
from benchmark.metrics._program import recorder, tracked_frames, window


def read(context):
    got = window(context)
    frames = tracked_frames(context)
    if got is None or frames == 0:
        return None
    return recorder().counts(got[1]).get("resolves", 0) / frames
