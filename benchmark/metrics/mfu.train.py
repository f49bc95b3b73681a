"""The window's share of the card's float32 peak: the model FLOPs of every
train step (rooflines/frtm_train.py; all float32) as seconds at 67 TFLOP/s
over the window's seconds, in percent."""
from benchmark.rooflines.peaks import FLOPS_PER_S


def read(context):
    f, w = context.get("flops", 0.0), context["window_s"]
    if w <= 0 or f <= 0:
        return None
    return 100.0 * f / FLOPS_PER_S["float32"] / w
