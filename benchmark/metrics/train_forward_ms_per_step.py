"""The train step's forward (PhaseTimer "forward": the backbone, the target
models' scores, the refiner in train mode and the loss over the train
frames), synchronised at its edges, ms a step."""
from benchmark.metrics._train import per_step_ms


def read(context):
    return per_step_ms(context, "forward")
