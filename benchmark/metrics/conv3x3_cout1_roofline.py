"""Kernel conv3x3_cout1's share of its roofline over the window's calls (CUDA events
around its entry point; bytes and FLOPs from rooflines/conv3x3_cout1.py)."""
from benchmark.metrics._roofline import share


def read(context):
    return share(context, ("conv3x3_cout1",))
