"""Kernel 2's input gradient (csrc/conv3x3_cout1_dx.cu), one call on the
output gradient (N, 1, H, W) and the weight (1, C, 3, 3): both read once and
the (N, C, H, W) input gradient written once; 9 multiply-adds a value."""
from math import prod

from .peaks import bytes_of


def cost(shapes, dtype, extra=None):
    n, _, h, w = shapes[0]
    c = shapes[1][1]
    return (prod(shapes[0]) + prod(shapes[1]) + n * c * h * w) * bytes_of(dtype), \
        2.0 * 9 * n * c * h * w
