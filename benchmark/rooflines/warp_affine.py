"""Kernel 3 (the affine warp), one call of (C, H, W) planes to (C, OH, OW)
by a forward matrix: the output written once in the source's type, and of the
source only its footprint read, the area the output maps back onto (|det| of
the inverse map's linear part times the output's area, at most the source's
area), without the taps' margin, so the bound is never above the true one;
a bicubic output takes 16 taps, a multiply and an add each."""
from .peaks import bytes_of

TAPS = {"nearest": 1, "bilinear": 4, "bicubic": 16}


def cost(shapes, dtype, extra):
    """extra: (inverse determinant, (OH, OW), mode) of the call."""
    c, h, w = shapes[0]
    inv_det, (oh, ow), mode = extra
    footprint = min(h * w, abs(inv_det) * oh * ow)
    elem = bytes_of(dtype)
    return (c * footprint + c * oh * ow) * elem, 2.0 * TAPS[mode] * c * oh * ow
