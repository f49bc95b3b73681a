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


def batch_norm_train(x, weight, bias, running_mean, running_var, momentum: float = 0.1,
                     eps: float = 1e-5):
    """Training batch norm (frtm_tpu/models/seg_network.py::_batch_norm_train):
    normalise with the batch statistics over (N, H, W), the biased variance,
    folded as in `batch_norm`; returns (y, (mean, var)), the momentum-updated
    running statistics, whose variance takes the unbiased batch variance.
    The new statistics carry no gradient."""
    mean = x.mean(dim=(0, 2, 3))
    var = torch.square(x - mean[:, None, None]).mean(dim=(0, 2, 3))
    n = x.shape[0] * x.shape[2] * x.shape[3]
    inv = weight * torch.rsqrt(var + eps)
    y = x * inv[:, None, None] + (bias - mean * inv)[:, None, None]
    with torch.no_grad():
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * (var * n / max(n - 1, 1))
    return y, (new_mean, new_var)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d's parameters and state-dict keys (so reference
    checkpoints load unchanged), applied from running statistics. Only with
    train_bn=True (the trainer's decoder) does it normalise with batch
    statistics; it then returns (y, new running statistics) and leaves its
    buffers as they are (seg_network.apply_bn_updates writes them). The
    module's own `training` flag is never read."""

    def forward(self, x, train_bn: bool = False):
        if train_bn:
            return batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                    self.running_var, eps=self.eps)
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, self.eps)
