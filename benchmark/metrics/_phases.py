"""Shared arithmetic of the phase readers: a phase's synchronised seconds
(or thread-CPU seconds) summed over the window's sequences, per unit."""


def per_unit_ms(context, phase, unit, cpu=False):
    """1000 x the phase's total over the window / the units; None where no
    sequence ran the phase. unit(record) -> the record's count."""
    total = count = 0.0
    seen = False
    for r in context["records"]:
        st = r["phases"].get(phase)
        if st is None:
            continue
        seen = True
        total += (st["cpu_ms_per_call"] * st["count"] / 1000.0) if cpu else st["total_s"]
        count += unit(r)
    if not seen or count == 0:
        return None
    return 1000.0 * total / count
