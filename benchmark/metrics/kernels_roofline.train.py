"""All hand-written kernels of the train step together (kernels 1 and 2
forward, and their three backward kernels): the sum of every call's least
time over the sum of its CUDA-event time."""
from benchmark.metrics._roofline import share


def read(context):
    return share(context, ("pyrup", "conv3x3_cout1", "pyrup_bwd", "conv3x3_cout1_dx",
                           "conv3x3_cout1_dw"))
