"""The optimizer's step (PhaseTimer "step": AMSGrad over the refiner's
parameters), synchronised at its edges, ms a step."""
from benchmark.metrics._train import per_step_ms


def read(context):
    return per_step_ms(context, "step")
