"""All hand-written kernels of the tracking path together (1, 2 and 3): the
sum of every call's least time over the sum of its CUDA-event time."""
from benchmark.metrics._roofline import share


def read(context):
    return share(context, ("pyrup", "conv3x3_cout1", "warp_affine"))
