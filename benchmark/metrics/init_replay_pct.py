"""The share of the window's target-model inits that a CUDA graph served:
100 x the port's `init_replays` counter (one a disc_init_graphed call a
replay served, 0 one run eagerly) over its `inits` counter (one a
disc_init_graphed call), over the window's sequences. A port that does not
count init replays reads as nothing."""
from benchmark.metrics._program import recorder, window


def read(context):
    got = window(context)
    if got is None:
        return None
    counts = recorder().counts(got[1])
    if "init_replays" not in counts or not counts.get("inits"):
        return None
    return 100.0 * counts["init_replays"] / counts["inits"]
