"""Kernel 1's backward (csrc/pyrup_bwd.cu), one call on the output gradient
(N, C, 2H, 2W): the gradient read once and the (N, C, H, W) input gradient
written once; 8 + 8 taps an input-gradient value along the two axes of the
separable stride-2 filter, a multiply and an add each."""
from math import prod

from .peaks import bytes_of


def cost(shapes, dtype, extra=None):
    """(bytes, FLOPs) of one call whose first argument (the output
    gradient) has shape shapes[0]."""
    n, c, h2, w2 = shapes[0]
    out = n * c * (h2 // 2) * (w2 // 2)
    return (prod(shapes[0]) + out) * bytes_of(dtype), 2.0 * 16 * out
