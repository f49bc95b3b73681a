"""Kernel 1 (the 2x bicubic pyramid upsampler), one call on (N, C, H, W):
its input read once and its (N, C, 2H, 2W) output written once; 4 + 4 taps
a output, a multiply and an add each."""
from math import prod

from .peaks import bytes_of


def cost(shapes, dtype, extra=None):
    """(bytes, FLOPs) of one call whose first argument has shape shapes[0]."""
    n, c, h, w = shapes[0]
    out = n * c * 4 * h * w
    return (prod(shapes[0]) + out) * bytes_of(dtype), 16.0 * out
