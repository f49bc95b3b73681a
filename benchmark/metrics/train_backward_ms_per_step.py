"""The train step's backward (PhaseTimer "backward": autograd through the
refiner, the three backward kernels among it), synchronised at its edges, ms
a step."""
from benchmark.metrics._train import per_step_ms


def read(context):
    return per_step_ms(context, "backward")
