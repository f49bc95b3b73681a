"""The cells' weights, made by the benchmark on the device from the
configuration file's `weight_seed` (never from --seed, so that every run
tracks with the same weights and meets the same work): one random draw for
all backbone convolutions, one for all refiner convolutions and one for the
target model's starting weights, each split into the
tensors of a state dict whose keys both the port's modules and the
reference's take (torchvision's and the reference checkpoint's names).

The backbone follows the port's own random init (utils/convert.py::
init_resnet): He-normal fan-out convolutions, unit batch norms but the last
of each residual branch at 0.1 (so a random rn101's levels keep a standard
deviation of 0.1-0.3, where the solve stays finite). The refiner's
convolutions are uniform within torch's default bounds, the score channel
raised (SCORE_GAIN). A random refiner's logits sit all on one side of 0, so `head_scale` maps its head to median 0
and standard deviation 2 on the reference's decode of one frame, and the
masks then hold both classes, as chip_smoke.py's scale_head does.
"""
import numpy as np
import torch

RESIDUAL_GAIN = 0.1
HEAD_SPREAD = 2.0
# A random refiner weighs the target model's score map as one channel among
# 65, and its masks follow the frame's texture more than the scores: they
# barely move with the objects, and a tracker that stopped tracking would
# still give most of the same labels. Scaled by this gain, the score channel
# (the last input of each TSE's first convolution) leads, as in a trained
# refiner, and the masks follow the objects.
SCORE_GAIN = 20.0


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + stream) % (1 << 63))
    return g


def _meta_state(module_fn):
    with torch.device("meta"):
        return module_fn().state_dict()


def _fill(shapes, draw, scale_of):
    """One draw for every tensor in `shapes` ({key: shape}), split and
    scaled by scale_of(key, shape) -> (factor, offset)."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = draw(sum(sizes))
    out, at = {}, 0
    for (key, shape), n in zip(shapes.items(), sizes):
        f, o = scale_of(key, shape)
        out[key] = (flat[at:at + n].view(shape) * f + o).contiguous()
        at += n
    return out


def backbone_state(arch: str, seed: int, device, block_of) -> dict:
    """{key: tensor} for a ResNet of `arch`; block_of(arch) -> "basic" or
    "bottleneck" names the residual branch's last batch norm."""
    from ..reference.resnet import ResNet
    meta = _meta_state(lambda: ResNet(arch))
    last_bn = "bn3" if block_of(arch) == "bottleneck" else "bn2"
    convs = {k: v.shape for k, v in meta.items() if v.dim() == 4}
    g = _generator(seed, 1, device)
    sd = _fill(convs, lambda n: torch.randn(n, generator=g, device=device),
               lambda k, s: (float(np.sqrt(2.0 / (s[0] * s[2] * s[3]))), 0.0))
    for k, v in meta.items():
        if k in sd:
            continue
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith("running_var"):
            sd[k] = torch.ones(v.shape, device=device)
        elif k.endswith(".weight"):
            gain = RESIDUAL_GAIN if k.startswith("layer") and k.endswith(f"{last_bn}.weight") else 1.0
            sd[k] = torch.full(v.shape, gain, device=device)
        else:       # batch-norm bias and running mean
            sd[k] = torch.zeros(v.shape, device=device)
    return sd


def refiner_state(ft_channels: dict, out_channels: int, seed: int, device) -> dict:
    """{key: tensor} for the refiner: convolution weights U(+-sqrt(1 /
    fan_in)), biases U(+-1 / sqrt(fan_in)), batch norms at identity; in each
    TSE's first convolution the score channel's weights times SCORE_GAIN."""
    from ..reference.seg_network import SegNetwork
    meta = _meta_state(lambda: SegNetwork(ft_channels, 1, out_channels))
    fan_in = {k[:-len(".weight")]: int(np.prod(v.shape[1:])) for k, v in meta.items()
              if v.dim() == 4}
    drawn = {k: v.shape for k, v in meta.items()
             if v.dim() == 4 or (k.endswith(".bias") and k[:-len(".bias")] in fan_in)}
    g = _generator(seed, 2, device)

    def bound(key, shape):
        n = fan_in[key.rsplit(".", 1)[0]]
        b = float(np.sqrt(1.0 / n)) if len(shape) == 4 else float(1.0 / np.sqrt(n))
        return 2 * b, -b

    sd = _fill(drawn, lambda n: torch.rand(n, generator=g, device=device), bound)
    for L in ft_channels:
        sd[f"TSE.{L}.transform.0.weight"][:, out_channels] *= SCORE_GAIN
    for k, v in meta.items():
        if k in sd:
            continue
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith("running_var") or k.endswith(".weight"):
            sd[k] = torch.ones(v.shape, device=device)
        else:
            sd[k] = torch.zeros(v.shape, device=device)
    return sd


def disc_start(in_channels: int, c_channels: int, seed: int, device):
    """The target model's starting weights, (c, Cin, 1, 1) and (1, c, 3, 3),
    uniform within torch's default bounds (the solve overwrites them)."""
    g = _generator(seed, 3, device)
    flat = torch.rand(c_channels * in_channels + 9 * c_channels, generator=g, device=device)
    b1 = float(np.sqrt(6.0 / (6.0 * in_channels)))
    b2 = float(np.sqrt(6.0 / (6.0 * 9 * c_channels)))
    project = (flat[:c_channels * in_channels] * 2 - 1).view(c_channels, in_channels, 1, 1) * b1
    filt = (flat[c_channels * in_channels:] * 2 - 1).view(1, c_channels, 3, 3) * b2
    return project.contiguous(), filt.contiguous()


def scale_head(refiner_sd: dict, median: float, std: float) -> None:
    """Map the head's logits l to (l - median) * HEAD_SPREAD / std, in place."""
    refiner_sd["project.conv2.weight"].mul_(HEAD_SPREAD / std)
    refiner_sd["project.conv2.bias"].sub_(median).mul_(HEAD_SPREAD / std)
