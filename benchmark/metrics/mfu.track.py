"""The window's share of the card's peak: the model FLOPs of every tracked
sequence (rooflines/frtm_model.py), backbone and decoder over the peak of the
configuration's compute type and the target model over float32's, summed as
seconds at peak over the window's seconds, in percent."""
from benchmark.rooflines.peaks import FLOPS_PER_S


def read(context):
    f, w = context["flops"], context["window_s"]
    if w <= 0 or f["compute"] + f["float32"] <= 0:
        return None
    at_peak = (f["compute"] / FLOPS_PER_S[context["config"]["compute_dtype"]]
               + f["float32"] / FLOPS_PER_S["float32"])
    return 100.0 * at_peak / w
