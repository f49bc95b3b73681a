"""SegNetwork — the multi-scale refinement decoder
(frtm_tpu/models/seg_network.py), inference mode.

Per refinement layer, deep to shallow: a target-specific encoder (TSE),
residual refinement blocks (RRB) around a channel-attention block (CAB);
then the "pyrup" upsampling head (the reference's
BackwardCompatibleUpsampler): kernel 1 (2x bicubic pyramid upsampler), a
3x3 conv, kernel 1 again, a bilinear resize to the image size, and kernel 2
(the 3x3 conv to one channel). Module names follow the reference checkpoint's
`refiner.*` keys (TSE.{L}.reduce.{0,2}, TSE.{L}.transform.{0,2,4},
RRB{1,2}.{L}.conv1x1 / .bblock.{0,1,3}, CAB.{L}.convreluconv.{0,2},
project.conv{1,2}), so its state dict loads with `load_state_dict`.
"""
import torch
import torch.nn as nn

from ..ops.conv import FrozenBatchNorm2d, relu
from ..ops.kernels import conv3x3_cout1, pyr_up_bicubic
from ..ops.resize import adaptive_cat, interpolate

LAYERS = ("layer5", "layer4", "layer3", "layer2")


def _conv(cin, cout, k, bias=True):
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)


class TSE(nn.Module):
    def __init__(self, fc, ic, oc):
        super().__init__()
        nc = ic + oc
        self.reduce = nn.Sequential(_conv(fc, oc, 1), nn.ReLU(), _conv(oc, oc, 1))
        self.transform = nn.Sequential(_conv(nc, nc, 3), nn.ReLU(), _conv(nc, nc, 3),
                                       nn.ReLU(), _conv(nc, oc, 3), nn.ReLU())


class RRB(nn.Module):
    def __init__(self, oc, use_bn=True):
        super().__init__()
        self.conv1x1 = _conv(oc, oc, 1)
        if use_bn:
            self.bblock = nn.Sequential(_conv(oc, oc, 3), FrozenBatchNorm2d(oc), nn.ReLU(),
                                        _conv(oc, oc, 3, bias=False))
        else:
            self.bblock = nn.Sequential(_conv(oc, oc, 3), nn.ReLU(),
                                        _conv(oc, oc, 3, bias=False))

    def forward(self, x):
        h = self.conv1x1(x)
        return relu(h + self.bblock(h))


class CAB(nn.Module):
    def __init__(self, oc):
        super().__init__()
        self.convreluconv = nn.Sequential(_conv(2 * oc, oc, 1), nn.ReLU(), _conv(oc, oc, 1))

    def forward(self, deeper, shallower, deepest):
        shallow_pool = shallower.mean(dim=(2, 3), keepdim=True)
        deeper_pool = deeper if deepest else deeper.mean(dim=(2, 3), keepdim=True)
        g = self.convreluconv(torch.cat([shallow_pool, deeper_pool], dim=1))
        return shallower * torch.sigmoid(g) + interpolate(deeper, shallower.shape[-2:])


class Upsampler(nn.Module):
    def __init__(self, oc):
        super().__init__()
        self.conv1 = _conv(oc, oc // 2, 3)
        self.conv2 = _conv(oc // 2, 1, 3)

    def forward(self, x, image_size):
        x = pyr_up_bicubic(x)
        x = relu(self.conv1(x))
        x = pyr_up_bicubic(x)
        x = interpolate(x, image_size)
        return conv3x3_cout1(x, self.conv2.weight, self.conv2.bias)


class SegNetwork(nn.Module):
    def __init__(self, ft_channels, in_channels=1, out_channels=32, use_bn=True):
        """:param ft_channels: deep-to-shallow {layer_name: feature channels}."""
        super().__init__()
        oc = out_channels
        self.layers = tuple(ft_channels)
        self.TSE = nn.ModuleDict({L: TSE(fc, in_channels, oc) for L, fc in ft_channels.items()})
        self.RRB1 = nn.ModuleDict({L: RRB(oc, use_bn) for L in ft_channels})
        self.CAB = nn.ModuleDict({L: CAB(oc) for L in ft_channels})
        self.RRB2 = nn.ModuleDict({L: RRB(oc, use_bn) for L in ft_channels})
        self.project = Upsampler(oc)

    def forward(self, scores, features, image_size, reduced=None):
        return seg_network_apply(self, scores, features, image_size, self.layers, reduced)


def _tse_reduce(tse: TSE, ft):
    h = tse.reduce(ft)
    return h, h.mean(dim=(2, 3), keepdim=True)


@torch.no_grad()
def seg_network_reduce(net: SegNetwork, features, layers=LAYERS):
    """Object-independent TSE reductions: {layer: (reduced, pooled)}."""
    return {L: _tse_reduce(net.TSE[L], features[L]) for L in layers}


@torch.no_grad()
def seg_network_apply(net: SegNetwork, scores, features, image_size, layers=LAYERS,
                      reduced=None):
    """Refine coarse scores into full-resolution mask logits.

    :param scores:     (N, 1, h, w) coarse target-model scores
    :param features:   {layer: (N, c, h, w)} backbone pyramid (may be None
                       when `reduced` is given)
    :param image_size: (H, W) output size
    :return: (N, 1, H, W) logits
    """
    x = None
    for i, L in enumerate(layers):
        h0, hpool = (_tse_reduce(net.TSE[L], features[L]) if reduced is None
                     else reduced[L])
        s = interpolate(scores, h0.shape[-2:])
        h = net.TSE[L].transform(adaptive_cat((h0, s), ref_index=0))
        if x is not None:
            hpool = x
        h = net.RRB1[L](h)
        h = net.CAB[L](hpool, h, deepest=(i == 0))
        x = net.RRB2[L](h)
    return net.project(x, image_size)
