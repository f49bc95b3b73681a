"""Kernel pyrup's share of its roofline over the window's calls (CUDA events
around its entry point; bytes and FLOPs from rooflines/pyrup.py)."""
from benchmark.metrics._roofline import share


def read(context):
    return share(context, ("pyrup",))
