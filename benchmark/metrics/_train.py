"""Shared part of the readers of a training cell's program spans and
counters (frtm_tpu_torch/utils/profiling.py, runtime/trainer.py):
harness/train.py resets the port's recorder at the window's start,
records over the window of the traced run alone, and hands the spans and
counts over in `context`. Each `train_step` span is one step. A port without
these spans or counters reads as nothing."""


def closed(context, name):
    return [s for s in context.get("program_spans", []) if s.name == name
            and s.end_ns is not None]


def per_step_ms(context, name):
    """The wall milliseconds of the window's spans named `name` over its
    steps; None where there are none."""
    steps = len(closed(context, "train_step"))
    chosen = closed(context, name)
    if steps == 0 or not chosen:
        return None
    return sum(s.end_ns - s.start_ns for s in chosen) / 1e6 / steps
