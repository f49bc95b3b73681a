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

With a spatial `mesh` (parallel/spatial.py, inference only) the decoder runs
on this rank's rows: the features are the rows of the row plan, with their
global `heights` (models/resnet.py::level_heights), and the scores are whole.
The convolutions with a height above one row, the resizes, the spatial means
and kernels 1 and 2 go through ops/halo.py, which without a mesh is the
unsharded operation; the logits are this rank's rows of the image.
"""
import torch
import torch.nn as nn

from ..ops import halo
from ..ops.conv import FrozenBatchNorm2d, relu

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

    def forward(self, x, bn_updates=None, key=None, bn_group=None, H=None, mesh=None):
        """With a bn_updates dict (training), the BatchNorm uses batch
        statistics (the global batch's over the process group `bn_group`)
        and its new running statistics go to bn_updates[key]. With a spatial
        mesh (inference), x is this rank's rows of a level of global height H."""
        h = self.conv1x1(x)
        if bn_updates is None or len(self.bblock) == 3:
            return relu(h + _seq(self.bblock, h, H, mesh))
        conv, bn, act, conv2 = self.bblock
        b, bn_updates[key] = bn(conv(h), train_bn=True, group=bn_group)
        return relu(h + conv2(act(b)))


class CAB(nn.Module):
    def __init__(self, oc):
        super().__init__()
        self.convreluconv = nn.Sequential(_conv(2 * oc, oc, 1), nn.ReLU(), _conv(oc, oc, 1))

    def forward(self, deeper, shallower, deepest, H=None, H_deeper=None, mesh=None):
        """H, H_deeper: the global heights of shallower and deeper (with a
        spatial mesh, where they are this rank's rows)."""
        H = shallower.shape[-2] if H is None else H
        shallow_pool = halo.spatial_mean(shallower, H, mesh)
        deeper_pool = deeper if deepest else halo.spatial_mean(deeper, H_deeper, mesh)
        g = self.convreluconv(torch.cat([shallow_pool, deeper_pool], dim=1))
        return shallower * torch.sigmoid(g) + halo.resize(
            deeper, (H, shallower.shape[-1]), "bilinear", H_deeper, mesh)


class Upsampler(nn.Module):
    def __init__(self, oc):
        super().__init__()
        self.conv1 = _conv(oc, oc // 2, 3)
        self.conv2 = _conv(oc // 2, 1, 3)

    def forward(self, x, image_size, style="pyrup", H=None, mesh=None):
        """H: x's global height (with a spatial mesh, where x is this rank's
        rows)."""
        H = x.shape[-2] if H is None else H
        if style == "pyrup":
            x = halo.pyr_up_bicubic(x, H, mesh)
            x = relu(halo.conv2d(x, self.conv1.weight, self.conv1.bias, H=2 * H, mesh=mesh))
            x = halo.pyr_up_bicubic(x, 2 * H, mesh)
            x = halo.resize(x, image_size, "bilinear", 4 * H, mesh)
        elif style == "bicubic":
            x = halo.resize(x, (2 * H, 2 * x.shape[-1]), "bicubic", H, mesh)
            x = relu(halo.conv2d(x, self.conv1.weight, self.conv1.bias, H=2 * H, mesh=mesh))
            x = halo.resize(x, image_size, "bicubic", 2 * H, mesh)
        else:
            raise ValueError(f"upsampler {style!r}: 'pyrup' or 'bicubic'")
        return halo.conv3x3_cout1(x, self.conv2.weight, self.conv2.bias, H=int(image_size[0]),
                                  mesh=mesh)


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


def _seq(seq, x, H=None, mesh=None):
    """An nn.Sequential of stride-1 convolutions and pointwise modules; with
    a spatial mesh, on this rank's rows of a level of global height H."""
    for m in seq:
        x = (halo.conv2d(x, m.weight, m.bias, padding=tuple(m.padding), H=H, mesh=mesh)
             if isinstance(m, nn.Conv2d) else m(x))
    return x


def _tse_reduce(tse: TSE, ft, H=None, mesh=None):
    h = tse.reduce(ft)                  # 1x1 convolutions: pointwise in height
    return h, halo.spatial_mean(h, H, mesh)


@torch.no_grad()
def seg_network_reduce(net: SegNetwork, features, layers=LAYERS, mesh=None, heights=None):
    """Object-independent TSE reductions: {layer: (reduced, pooled)}; with a
    spatial mesh, of this rank's rows (the pooled means global)."""
    return {L: _tse_reduce(net.TSE[L], features[L], heights[L] if heights else None, mesh)
            for L in layers}


def seg_network_apply(net: SegNetwork, scores, features, image_size, layers=LAYERS,
                      reduced=None, upsampler="pyrup", train_bn: bool = False, bn_group=None,
                      mesh=None, heights=None):
    """Refine coarse scores into full-resolution mask logits.

    :param scores:     (N, 1, h, w) coarse target-model scores, or a list of
                       them (one per target-model layer)
    :param features:   {layer: (N, c, h, w)} backbone pyramid (may be None
                       when `reduced` is given)
    :param image_size: (H, W) output size
    :param upsampler:  the head, 'pyrup' or 'bicubic'
    :param train_bn:   training: record gradients and normalise the RRB
                       BatchNorms with batch statistics
    :param bn_group:   with train_bn, a torch.distributed process group over
                       whose ranks the batch statistics are taken (data-
                       parallel training; None: this process's batch)
    :param mesh:       a spatial mesh (inference): features and `reduced`
                       are this rank's rows, `heights` {layer: global
                       height}; the logits are this rank's rows
    :return: (N, 1, H, W) logits; with train_bn, (logits, bn_updates), where
             bn_updates maps (rrb name, layer) -> (running mean, running var)
    """
    if train_bn:
        if halo.active(mesh):
            raise ValueError("seg_network_apply: height sharding serves inference only")
        bn_updates = {}
        return _apply(net, scores, features, image_size, layers, reduced, upsampler,
                      bn_updates, bn_group), bn_updates
    with torch.no_grad():
        return _apply(net, scores, features, image_size, layers, reduced, upsampler, None,
                      mesh=mesh, heights=heights)


def _apply(net, scores, features, image_size, layers, reduced, upsampler, bn_updates,
           bn_group=None, mesh=None, heights=None):
    score_list = scores if isinstance(scores, (list, tuple)) else [scores]
    x = H_x = None
    for i, L in enumerate(layers):
        H = heights[L] if heights else None
        h0, hpool = (_tse_reduce(net.TSE[L], features[L], H, mesh) if reduced is None
                     else reduced[L])
        H = h0.shape[-2] if H is None else H
        size = (H, h0.shape[-1])
        s = [halo.resize(ss, size, "bilinear", ss.shape[-2], mesh) for ss in score_list]
        h = _seq(net.TSE[L].transform, torch.cat([h0, *s], dim=1), H, mesh)
        h = net.RRB1[L](h, bn_updates, ("RRB1", L), bn_group, H, mesh)
        # the deepest layer's "deeper" input is its pooled reduction
        h = (net.CAB[L](hpool, h, True, H, 1, mesh) if x is None
             else net.CAB[L](x, h, False, H, H_x, mesh))
        x, H_x = net.RRB2[L](h, bn_updates, ("RRB2", L), bn_group, H, mesh), H
    return net.project(x, image_size, upsampler, H_x, mesh)


@torch.no_grad()
def apply_bn_updates(net: SegNetwork, bn_updates):
    """Write train-mode running statistics into the RRB BatchNorms. Only the
    running mean and var: BN weight and bias are trained parameters."""
    for (rrb, L), (mean, var) in bn_updates.items():
        bn = getattr(net, rrb)[L].bblock[1]
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
