"""Kernel warp_affine's share of its roofline over the window's calls (CUDA events
around its entry point; bytes and FLOPs from rooflines/warp_affine.py)."""
from benchmark.metrics._roofline import share


def read(context):
    return share(context, ("warp_affine",))
