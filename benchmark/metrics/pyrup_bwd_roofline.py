"""Kernel pyrup_bwd's share of its roofline over the window's calls (CUDA
events around its launches; bytes and FLOPs from rooflines/pyrup_bwd.py)."""
from benchmark.metrics._roofline import share


def read(context):
    return share(context, ("pyrup_bwd",))
