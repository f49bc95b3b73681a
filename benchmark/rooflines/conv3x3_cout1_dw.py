"""Kernel 2's weight and bias gradient (csrc/conv3x3_cout1_dw.cu), one call
on the input (N, C, H, W) and the output gradient (N, 1, H, W): both read
once and the 9 C + 1 gradients written once (the kernel's partial sums
between its two passes are not counted); 9 C multiply-adds and one add an
output-gradient value."""
from math import prod

from .peaks import bytes_of


def cost(shapes, dtype, extra=None):
    n, c, h, w = shapes[0]
    return (prod(shapes[0]) + prod(shapes[1]) + 9 * c + 1) * bytes_of(dtype), \
        2.0 * 9 * n * c * h * w + n * h * w
