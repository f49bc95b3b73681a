"""The wall time of the port's `label_download` spans (run_sequence copying
the tracked labels to the host after its clock) in ms over the tracked
frames (every frame but the first, whose labels are the host's)."""
from benchmark.metrics._program import per_unit_ms, tracked_frames


def read(context):
    return per_unit_ms(context, "label_download", tracked_frames(context))
