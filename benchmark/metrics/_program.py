"""Shared part of the readers of the port's own spans and counters
(frtm_tpu_torch/utils/profiling.py), which the tracker records in the traced
run (its `profile=True`), the warm-up's with the window's. Each sequence the
port tracked is a request of its own, and the window's sequences are the
last ones it tracked, one record each: their requests pick the window's
spans and counts. A port without the recorder reads as nothing."""


def recorder():
    """The port's profiling module where it records spans, else None."""
    from frtm_tpu_torch.utils import profiling
    return profiling if hasattr(profiling, "spans") else None


def window(context):
    """(the window's closed spans, their requests, the issuing thread), or
    None where the port recorded no span of each of the window's sequences."""
    profiling = recorder()
    n = len(context["records"])
    if profiling is None or n == 0:
        return None
    spans = [s for s in profiling.spans() if s.end_ns is not None]
    seqs = [s for s in spans if s.name == "run_sequence"]
    if len(seqs) < n:
        return None
    requests = {s.request for s in seqs[-n:]}
    return [s for s in spans if s.request in requests], requests, seqs[-1].thread


def tracked_frames(context):
    return sum(r["frames"] - 1 for r in context["records"])


def per_unit_ms(context, name, units, cpu=False):
    """1000 x the wall (or thread-CPU) seconds of the window's spans named
    `name` over `units`; None where there are none."""
    got = window(context)
    if got is None or units == 0:
        return None
    chosen = [s for s in got[0] if s.name == name]
    if not chosen:
        return None
    ns = sum(s.cpu_ns if cpu else s.end_ns - s.start_ns for s in chosen)
    return ns / 1e6 / units
