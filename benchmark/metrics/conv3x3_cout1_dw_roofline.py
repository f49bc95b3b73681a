"""Kernel conv3x3_cout1_dw's share of its roofline over the window's calls (CUDA
events around its launches; bytes and FLOPs from rooflines/conv3x3_cout1_dw.py)."""
from benchmark.metrics._roofline import share


def read(context):
    return share(context, ("conv3x3_cout1_dw",))
