"""The refinement decoder for inference in float32: a frozen copy of the
port's models/seg_network.py (the "pyrup" head, no height sharding, no
training form), with kernels 1 and 2 in their plain versions. Module names
follow the reference checkpoint's `refiner.*` keys, so the benchmark's state
dict loads into it and into the port's module alike. `fp8` (the control)
rounds every convolution's operands to float8 e4m3 (kernel 2's too)."""
import torch
import torch.nn as nn

from . import kernels_plain
from .conv import FrozenBatchNorm2d, conv2d, fp8_round, relu
from .resize import resize

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
    def __init__(self, oc):
        super().__init__()
        self.conv1x1 = _conv(oc, oc, 1)
        self.bblock = nn.Sequential(_conv(oc, oc, 3), FrozenBatchNorm2d(oc), nn.ReLU(),
                                    _conv(oc, oc, 3, bias=False))


class CAB(nn.Module):
    def __init__(self, oc):
        super().__init__()
        self.convreluconv = nn.Sequential(_conv(2 * oc, oc, 1), nn.ReLU(), _conv(oc, oc, 1))


class Upsampler(nn.Module):
    def __init__(self, oc):
        super().__init__()
        self.conv1 = _conv(oc, oc // 2, 3)
        self.conv2 = _conv(oc // 2, 1, 3)


class SegNetwork(nn.Module):
    def __init__(self, ft_channels, in_channels=1, out_channels=32):
        """:param ft_channels: deep-to-shallow {layer_name: feature channels}."""
        super().__init__()
        oc = out_channels
        self.fp8 = False
        self.TSE = nn.ModuleDict({L: TSE(fc, in_channels, oc) for L, fc in ft_channels.items()})
        self.RRB1 = nn.ModuleDict({L: RRB(oc) for L in ft_channels})
        self.CAB = nn.ModuleDict({L: CAB(oc) for L in ft_channels})
        self.RRB2 = nn.ModuleDict({L: RRB(oc) for L in ft_channels})
        self.project = Upsampler(oc)
        self.requires_grad_(False)

    def _seq(self, seq, x):
        for m in seq:
            x = (conv2d(x, m.weight, m.bias, padding=tuple(m.padding), fp8=self.fp8)
                 if isinstance(m, nn.Conv2d) else m(x))
        return x

    def _rrb(self, rrb, x):
        h = self._seq([rrb.conv1x1], x)
        return relu(h + self._seq(rrb.bblock, h))

    def _cab(self, cab, deeper, shallower, deepest):
        shallow_pool = shallower.mean(dim=(-2, -1), keepdim=True)
        deeper_pool = deeper if deepest else deeper.mean(dim=(-2, -1), keepdim=True)
        g = self._seq(cab.convreluconv, torch.cat([shallow_pool, deeper_pool], dim=1))
        return shallower * torch.sigmoid(g) + resize(deeper, shallower.shape[-2:], "bilinear")

    @torch.no_grad()
    def apply(self, scores, features, image_size, layers=LAYERS):
        """(N, 1, h, w) coarse scores and {layer: (N, c, h, w)} features ->
        (N, 1, H, W) logits."""
        x = None
        for L in layers:
            h0 = self._seq(self.TSE[L].reduce, features[L])
            hpool = h0.mean(dim=(-2, -1), keepdim=True)
            s = resize(scores, h0.shape[-2:], "bilinear")
            h = self._seq(self.TSE[L].transform, torch.cat([h0, s], dim=1))
            h = self._rrb(self.RRB1[L], h)
            h = (self._cab(self.CAB[L], hpool, h, True) if x is None
                 else self._cab(self.CAB[L], x, h, False))
            x = self._rrb(self.RRB2[L], h)
        up = self.project
        q = fp8_round if self.fp8 else (lambda t: t)
        x = kernels_plain.pyr_up_bicubic(x)
        x = relu(conv2d(x, up.conv1.weight, up.conv1.bias, fp8=self.fp8))
        x = kernels_plain.pyr_up_bicubic(x)
        x = resize(x, image_size, "bilinear")
        return kernels_plain.conv3x3_cout1(q(x), q(up.conv2.weight), up.conv2.bias)
