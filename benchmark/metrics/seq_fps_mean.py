"""The mean over the window's sequences of run_sequence's fps: frames over
the synchronised clock around the sequence's tracking, augment and init
inside it (the paper's per-sequence protocol)."""


def read(context):
    fps = [r["fps"] for r in context["records"]]
    return sum(fps) / len(fps) if fps else None
