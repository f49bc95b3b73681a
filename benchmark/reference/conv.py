"""Convolution, inference batch norm and ReLU on NCHW float32 tensors, with
torch-style k // 2 padding (a frozen copy of the port's ops/conv.py, its
inference path only), and the rounding of the lower-precision control.

`fp8_round` is the control's step below bfloat16: a tensor scaled by its
largest magnitude onto float8 e4m3's range (448), rounded to that type and
scaled back, as a per-tensor scaled fp8 convolution would see its operands.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


def conv2d(x, w, b=None, stride: int = 1, dilation: int = 1, padding=None, fp8: bool = False):
    """x: (N, Cin, H, W), w: (Cout, Cin, kh, kw), symmetric k // 2 padding;
    fp8: both operands rounded by fp8_round first (the control)."""
    kh, kw = w.shape[-2], w.shape[-1]
    if padding is None:
        padding = (dilation * (kh // 2), dilation * (kw // 2))
    if fp8:
        x, w = fp8_round(x), fp8_round(w)
    return F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation)


def batch_norm(x, weight, bias, running_mean, running_var, eps: float = 1e-5):
    inv = weight * torch.rsqrt(running_var + eps)
    shift = bias - running_mean * inv
    return x * inv[:, None, None] + shift[:, None, None]


def relu(x):
    return torch.clamp_min(x, 0)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and state-dict keys, applied from its
    running statistics."""

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          self.eps)
