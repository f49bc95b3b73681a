"""Checkpoint loading (frtm_tpu/utils/checkpoints.py): the reference's torch
`.pth` files into the port's modules.

A published FRTM checkpoint holds only `refiner.*` keys (the backbone is not
part of it), so a full model is the refiner from the .pth plus a
torchvision-format backbone state dict. The port's modules keep the
reference's parameter names, so both are `load_state_dict` calls. The port's
own format is a `.pth` as well; the JAX package's `.npz` pytree format has no
counterpart here.
"""
from pathlib import Path

import torch

from ..config import autodetect_arch
from ..device import resolve_device
from ..models.resnet import ResNet, resnet_out_channels
from ..models.seg_network import LAYERS, SegNetwork

_REFINER_PREFIX = "refiner."


def _looks_like_state_dict(d) -> bool:
    return any(k.endswith(".weight") for k in d)


def load_torch_state_dict(path) -> dict:
    """{key: CPU tensor} from a .pth that holds either a raw state dict or a
    trainer checkpoint with a 'model' entry. Only tensors and plain
    containers are unpickled (`weights_only`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt and not _looks_like_state_dict(ckpt):
        ckpt = ckpt["model"]
    return {k: torch.as_tensor(v).detach() for k, v in ckpt.items()}


def load_reference_model(path, device=None):
    """A published FRTM checkpoint -> (arch, SegNetwork), the backbone
    autodetected from the refiner's layer4 input width."""
    sd = load_torch_state_dict(path)
    arch = autodetect_arch(sd)
    refiner_sd = {k[len(_REFINER_PREFIX):]: v for k, v in sd.items()
                  if k.startswith(_REFINER_PREFIX)}
    channels = resnet_out_channels(arch)
    refiner = SegNetwork(
        {L: channels[L] for L in LAYERS},
        in_channels=refiner_sd[f"TSE.{LAYERS[0]}.transform.0.weight"].shape[1]
        - refiner_sd["project.conv1.weight"].shape[1],
        out_channels=refiner_sd["project.conv1.weight"].shape[1],
        use_bn=f"RRB1.{LAYERS[0]}.bblock.1.weight" in refiner_sd)
    refiner.load_state_dict(refiner_sd)
    return arch, refiner.to(resolve_device(device)).eval()


def load_backbone(path_or_sd, arch: str, device=None) -> ResNet:
    """A torchvision-format resnet state dict (a .pth path or the dict) ->
    the port's frozen ResNet. The classifier head (`fc.*`), which the
    feature pyramid does not use, is dropped."""
    sd = load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, (str, Path)) \
        else dict(path_or_sd)
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    net = ResNet(arch)
    net.load_state_dict(sd)
    return net.to(resolve_device(device)).eval()
