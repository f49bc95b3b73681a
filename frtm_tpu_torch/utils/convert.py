"""Weights carried into the port.

* From the JAX package: `resnet_from_jax`, `seg_network_from_jax` and
  `disc_params_from_jax` take its parameter pytrees as nested dicts / lists /
  tuples of NUMPY arrays (convert with `jax.tree.map(np.asarray, params)`
  first; this module imports no JAX) and return the port's state dicts:
  HWIO -> OIHW, BN scale / bias / mean / var -> weight / bias /
  running_mean / running_var.
* `disc_params_to_jax` is the way back, for the target-model cache that
  both packages read (runtime/trainer.py::TModelCache).
* `disc_objects_from_jax` takes the fused tracker's target models (params
  and states with a leading object axis) and returns the port's, which
  keeps that axis, so that a test can compare both sides after the init or
  hand one side's state to the other.
* The port's own seeded init from a torch.Generator: `init_resnet`
  (He-normal fan-out convs; see its note on residual gains) and
  `init_seg_network` (torch Conv2d's default uniform bounds).
"""
import numpy as np
import torch

from ..device import resolve_device
from ..models.discriminator import DiscParams, DiscState
from ..models.memory import MemoryState
from ..models.resnet import RESNET_SPECS, ResNet
from ..models.seg_network import SegNetwork
from ..models.solver import CGState

_RESIDUAL_GAIN = 0.1


def _oihw(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w, np.float32),
                                                              (3, 2, 0, 1))))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _bn(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(p["mean"])
    sd[f"{name}.running_var"] = _t(p["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _oihw(p["w"])
    if p.get("b") is not None:
        sd[f"{name}.bias"] = _t(p["b"])


def resnet_from_jax(tree) -> dict:
    """frtm_tpu init_resnet / resnet_from_torch_state_dict tree -> ResNet state dict."""
    sd = {"conv1.weight": _oihw(tree["conv1"])}
    _bn(sd, "bn1", tree["bn1"])
    for si, stage in enumerate(tree["stages"]):
        for bi, blk in enumerate(stage):
            p = f"layer{si + 1}.{bi}"
            for key, val in blk.items():
                if key.startswith("conv"):
                    sd[f"{p}.{key}.weight"] = _oihw(val)
                elif key.startswith("bn"):
                    _bn(sd, f"{p}.{key}", val)
            if "downsample" in blk:
                sd[f"{p}.downsample.0.weight"] = _oihw(blk["downsample"]["conv"])
                _bn(sd, f"{p}.downsample.1", blk["downsample"]["bn"])
    return sd


def seg_network_from_jax(tree) -> dict:
    """frtm_tpu init_seg_network tree -> SegNetwork state dict (the reference
    checkpoint's refiner key names, without the 'refiner.' prefix)."""
    sd = {}
    for L, p in tree["tse"].items():
        for k, j in (("reduce.0", "reduce1"), ("reduce.2", "reduce2"), ("transform.0", "transform1"),
                     ("transform.2", "transform2"), ("transform.4", "transform3")):
            _conv(sd, f"TSE.{L}.{k}", p[j])
    for rrb, R in (("rrb1", "RRB1"), ("rrb2", "RRB2")):
        for L, p in tree[rrb].items():
            _conv(sd, f"{R}.{L}.conv1x1", p["conv1x1"])
            _conv(sd, f"{R}.{L}.bblock.0", p["bb1"])
            if "bn" in p:
                _bn(sd, f"{R}.{L}.bblock.1", p["bn"])
                _conv(sd, f"{R}.{L}.bblock.3", p["bb2"])
            else:
                _conv(sd, f"{R}.{L}.bblock.2", p["bb2"])
    for L, p in tree["cab"].items():
        _conv(sd, f"CAB.{L}.convreluconv.0", p["conv1"])
        _conv(sd, f"CAB.{L}.convreluconv.2", p["conv2"])
    _conv(sd, "project.conv1", tree["up"]["conv1"])
    _conv(sd, "project.conv2", tree["up"]["conv2"])
    return sd


def disc_params_from_jax(project, filter) -> DiscParams:
    """JAX DiscParams leaves (1, 1, Cin, c) / (3, 3, c, out) -> OIHW."""
    return DiscParams(_oihw(project), _oihw(filter))


def disc_params_to_jax(params: DiscParams):
    """DiscParams (OIHW) -> numpy (project (1, 1, Cin, c), filter (3, 3, c, out))."""
    return tuple(np.ascontiguousarray(np.transpose(t.detach().cpu().numpy(), (2, 3, 1, 0)))
                 for t in params)


def disc_objects_from_jax(params, states, device=None):
    """The JAX fused tracker's target models -> the port's (DiscParams,
    DiscState) of N objects, built straight from the JAX leading axis.

    :param params: DiscParams leaves with a leading object axis, as numpy:
        (project (N, 1, 1, Cin, c), filter (N, 3, 3, c, out))
    :param states: DiscState with a leading object axis, as nested tuples of
        numpy arrays in the JAX field order: (memory (samples (N, cap, h, w, c),
        labels (N, cap, H, W, 1), pixel_weights, weights (N, cap),
        current_size (N,), prev_ind (N,)), cg (p, r_prev, rho, have_p,
        step_alpha), frame_num (N,))
    """
    dev = resolve_device(device)
    project, filt = params
    memory, cg, frame_num = states
    samples, labels, pixel_weights, weights, current_size, prev_ind = memory
    cg_p, cg_r_prev, rho, have_p, step_alpha = cg

    def nchw(a):            # (N, cap, h, w, c) -> (N, cap, c, h, w); always a copy:
        # the memory's stores are written in place
        return torch.from_numpy(np.array(np.moveaxis(np.asarray(a, np.float32), -1, 2),
                                         order="C")).to(dev)

    def oihw(a):            # (N, kh, kw, i, o) -> (N, o, i, kh, kw)
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(a, np.float32), (0, 4, 3, 1, 2)))).to(dev)

    def vec(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a)).to(dtype).to(dev)

    mem = MemoryState(samples=nchw(samples), labels=nchw(labels),
                      pixel_weights=nchw(pixel_weights), weights=vec(weights),
                      current_size=vec(current_size, torch.int64),
                      prev_ind=vec(prev_ind, torch.int64))
    n = mem.weights.shape[0]
    cg_state = CGState(p=tuple(oihw(a) for a in cg_p), r_prev=tuple(oihw(a) for a in cg_r_prev),
                       rho=vec(rho), have_p=vec(have_p, torch.bool), step_alpha=vec(step_alpha))
    state = DiscState(memory=mem, cg=cg_state, frame_num=[int(f) for f in frame_num],
                      n_resolves=torch.zeros(n, dtype=torch.int64, device=dev))
    return DiscParams(oihw(project), oihw(filt)), state


@torch.no_grad()
def init_resnet(arch: str, generator: torch.Generator, device=None) -> ResNet:
    """Random backbone: He-normal (fan-out) convs, identity batch norms
    except the last one of each residual branch, whose scale starts at
    _RESIDUAL_GAIN. With unit gains every block adds its branch's variance
    and a random rn101 reaches a layer4 std of ~8e3 (64x96 input), where the
    target model's GN-CG solve overflows float32; at 0.1 every level stays
    at std 0.1-0.3, as trained weights keep it."""
    net = ResNet(arch)
    last_bn = "bn3" if RESNET_SPECS[arch][0] == "bottleneck" else "bn2"
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            cout, _, kh, kw = m.weight.shape
            std = float(np.sqrt(2.0 / (kh * kw * cout)))
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
        if name.startswith("layer") and name.endswith(last_bn):
            m.weight.fill_(_RESIDUAL_GAIN)
    return net.to(resolve_device(device))


@torch.no_grad()
def init_seg_network(ft_channels, generator: torch.Generator, in_channels=1,
                     out_channels=32, use_bn=True, device=None) -> SegNetwork:
    """Random refiner with torch Conv2d's default bounds:
    weight U(+-sqrt(1 / fan_in)), bias U(+-1 / sqrt(fan_in))."""
    net = SegNetwork(ft_channels, in_channels, out_channels, use_bn)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            bound = float(np.sqrt(6.0 / ((1 + 5.0) * fan_in)))
            m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound)
            if m.bias is not None:
                bb = float(1.0 / np.sqrt(fan_in))
                m.bias.copy_((torch.rand(m.bias.shape, generator=generator) * 2 - 1) * bb)
    return net.to(resolve_device(device))
