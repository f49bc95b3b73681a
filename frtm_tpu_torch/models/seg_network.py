"""SegNetwork — the multi-scale refinement decoder
(frtm_tpu/models/seg_network.py), for inference and for training.

Per refinement layer, deep to shallow: a target-specific encoder (TSE),
residual refinement blocks (RRB) around a channel-attention block (CAB);
then the "pyrup" upsampling head (the reference's
BackwardCompatibleUpsampler, the default): kernel 1 (2x bicubic pyramid
upsampler), a 3x3 conv, kernel 1 again, a bilinear resize to the image size,
and kernel 2 (the 3x3 conv to one channel). The legacy "bicubic" head (the
JAX package's `upsampler="bicubic"`) resizes by plain bicubic interpolation
instead, to twice the size and then to the image size, around the same two
convs. The scores may be one map or a list of maps, one per target-model
layer (multilayer models), resized to each refinement layer and
concatenated on the channel axis; the TSE then takes that many score
channels (`in_channels`). Module names follow the reference checkpoint's
`refiner.*` keys (TSE.{L}.reduce.{0,2}, TSE.{L}.transform.{0,2,4},
RRB{1,2}.{L}.conv1x1 / .bblock.{0,1,3}, CAB.{L}.convreluconv.{0,2},
project.conv{1,2}), so its state dict loads with `load_state_dict`.

The module computes in the type of its own parameters. For bfloat16 (the
fused tracker's decoder) take `compute_copy(net, torch.bfloat16)` once and
cast features and scores at its door; kernels 1 and 2 then run their
bfloat16 instances, the resizes compute in float32 and cast back
(ops/resize.py), and the caller takes the sigmoid in float32 on the cast
logits.
"""
import torch
import torch.nn as nn

from ..ops.conv import FrozenBatchNorm2d, relu
from ..ops.kernels import conv3x3_cout1, pyr_up_bicubic
from ..ops.resize import adaptive_cat, interpolate, resize

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

    def forward(self, x, bn_updates=None, key=None):
        """With a bn_updates dict (training), the BatchNorm uses batch
        statistics and its new running statistics go to bn_updates[key]."""
        h = self.conv1x1(x)
        if bn_updates is None or len(self.bblock) == 3:
            return relu(h + self.bblock(h))
        conv, bn, act, conv2 = self.bblock
        b, bn_updates[key] = bn(conv(h), train_bn=True)
        return relu(h + conv2(act(b)))


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

    def forward(self, x, image_size, style="pyrup"):
        if style == "pyrup":
            x = pyr_up_bicubic(x)
            x = relu(self.conv1(x))
            x = pyr_up_bicubic(x)
            x = interpolate(x, image_size)
        elif style == "bicubic":
            x = resize(x, (2 * x.shape[-2], 2 * x.shape[-1]), "bicubic")
            x = relu(self.conv1(x))
            x = resize(x, image_size, "bicubic")
        else:
            raise ValueError(f"upsampler {style!r}: 'pyrup' or 'bicubic'")
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


def seg_network_apply(net: SegNetwork, scores, features, image_size, layers=LAYERS,
                      reduced=None, upsampler="pyrup", train_bn: bool = False):
    """Refine coarse scores into full-resolution mask logits.

    :param scores:     (N, 1, h, w) coarse target-model scores, or a list of
                       them (one per target-model layer)
    :param features:   {layer: (N, c, h, w)} backbone pyramid (may be None
                       when `reduced` is given)
    :param image_size: (H, W) output size
    :param upsampler:  the head, 'pyrup' or 'bicubic'
    :param train_bn:   training: record gradients and normalise the RRB
                       BatchNorms with batch statistics
    :return: (N, 1, H, W) logits; with train_bn, (logits, bn_updates), where
             bn_updates maps (rrb name, layer) -> (running mean, running var)
    """
    if train_bn:
        bn_updates = {}
        return _apply(net, scores, features, image_size, layers, reduced, upsampler,
                      bn_updates), bn_updates
    with torch.no_grad():
        return _apply(net, scores, features, image_size, layers, reduced, upsampler, None)


def _apply(net, scores, features, image_size, layers, reduced, upsampler, bn_updates):
    score_list = scores if isinstance(scores, (list, tuple)) else [scores]
    x = None
    for i, L in enumerate(layers):
        h0, hpool = (_tse_reduce(net.TSE[L], features[L]) if reduced is None
                     else reduced[L])
        s = torch.cat([interpolate(ss, h0.shape[-2:]) for ss in score_list], dim=1) \
            if len(score_list) > 1 else interpolate(score_list[0], h0.shape[-2:])
        h = net.TSE[L].transform(adaptive_cat((h0, s), ref_index=0))
        if x is not None:
            hpool = x
        h = net.RRB1[L](h, bn_updates, ("RRB1", L))
        h = net.CAB[L](hpool, h, deepest=(i == 0))
        x = net.RRB2[L](h, bn_updates, ("RRB2", L))
    return net.project(x, image_size, upsampler)


@torch.no_grad()
def apply_bn_updates(net: SegNetwork, bn_updates):
    """Write train-mode running statistics into the RRB BatchNorms. Only the
    running mean and var: BN weight and bias are trained parameters."""
    for (rrb, L), (mean, var) in bn_updates.items():
        bn = getattr(net, rrb)[L].bblock[1]
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
