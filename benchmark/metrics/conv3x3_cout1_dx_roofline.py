"""Kernel conv3x3_cout1_dx's share of its roofline over the window's calls (CUDA
events around its launches; bytes and FLOPs from rooflines/conv3x3_cout1_dx.py)."""
from benchmark.metrics._roofline import share


def read(context):
    return share(context, ("conv3x3_cout1_dx",))
