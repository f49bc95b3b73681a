"""Convolution, pooling and inference batch norm on NCHW tensors with
torch-style k//2 padding (frtm_tpu/ops/conv.py's direct path; the TPU's
tap-sum, W-fold and space-to-depth lowerings compute the same products and
have no counterpart here)."""
import copy

import torch
import torch.nn as nn
import torch.nn.functional as F


def compute_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """`module` itself for float32; for another type a copy, made now, whose
    floating parameters and buffers are cast to it. The port computes in one
    known type per tensor: a module runs in its parameters' type, callers
    cast at its edges, and `torch.autocast`, which would choose per
    operation, is not used. A tracker makes its copies once, when it is
    built; later changes to the float32 module do not reach them."""
    if dtype == torch.float32:
        return module
    return copy.deepcopy(module).to(dtype)


def conv2d(x, w, b=None, stride: int = 1, dilation: int = 1):
    """x: (N, Cin, H, W), w: (Cout, Cin, kh, kw), symmetric k//2 padding."""
    kh, kw = w.shape[-2], w.shape[-1]
    return F.conv2d(x, w, b, stride=stride,
                    padding=(dilation * (kh // 2), dilation * (kw // 2)),
                    dilation=dilation)


def max_pool_3x3_s2(x):
    """3x3/stride-2 max pool with padding 1 (the ResNet stem pooling)."""
    return F.max_pool2d(x, 3, 2, 1)


def batch_norm(x, weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Inference batch norm folded into one multiply-add per channel, as in
    the JAX package: x * inv + (bias - mean * inv), inv = w / sqrt(var + eps)."""
    inv = weight * torch.rsqrt(running_var + eps)
    shift = bias - running_mean * inv
    return x * inv[:, None, None] + shift[:, None, None]


def relu(x):
    return torch.clamp_min(x, 0)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and state-dict keys (so reference
    checkpoints load unchanged), always applied from running statistics."""

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, self.eps)
