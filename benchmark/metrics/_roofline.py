"""Shared arithmetic of the roofline readers: over the window's calls of the
named kernels, the sum of each call's least time (rooflines/<kernel>.py's
bytes and FLOPs at the published peaks) over the sum of its CUDA-event time,
in percent; None where no call was timed."""
import importlib


def share(context, kernels):
    bound = measured = 0.0
    for c in context.get("kernel_calls", []):
        if c["kernel"] not in kernels:
            continue
        cost = importlib.import_module(f"benchmark.rooflines.{c['kernel']}").cost
        peaks = importlib.import_module("benchmark.rooflines.peaks")
        nbytes, flops = cost(c["shapes"], c["dtype"], c["extra"])
        bound += peaks.bound_seconds(nbytes, flops, c["dtype"])
        measured += c["ms"] / 1000.0
    return 100.0 * bound / measured if measured > 0 else None
