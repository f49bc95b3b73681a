"""Kernel 2 (the decoder head: a 3x3 convolution to one channel), one call
on x (N, C, H, W), w (1, C, 3, 3), b (1,): x, w and b read once, the
(N, 1, H, W) output written once; 9 C multiply-adds an output."""
from math import prod

from .peaks import bytes_of


def cost(shapes, dtype, extra=None):
    n, c, h, w = shapes[0]
    operands = sum(prod(s) for s in shapes if s is not None)
    return (operands + n * h * w) * bytes_of(dtype), 2.0 * 9 * c * n * h * w
