"""The Trainer loop's wait for the next batch from its prefetch thread (span
`data_wait`, outside the step), ms a step."""
from benchmark.metrics._train import per_step_ms


def read(context):
    return per_step_ms(context, "data_wait")
