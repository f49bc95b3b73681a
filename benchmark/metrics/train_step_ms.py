"""One train step (the port's `train_step` span: from the batch's hand-over to
the end of TrainerModel.train_step, target-model reads included), wall ms,
the window's mean. The traced run's PhaseTimer synchronises at its phase
edges, so the span holds the device's work."""
from benchmark.metrics._train import per_step_ms


def read(context):
    return per_step_ms(context, "train_step")
