"""build_disc_batch's target-model cache reads and their upload (span
`tmodel_load`), ms a step."""
from benchmark.metrics._train import per_step_ms


def read(context):
    return per_step_ms(context, "tmodel_load")
