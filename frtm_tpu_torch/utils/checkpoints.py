"""Checkpoint loading (frtm_tpu/utils/checkpoints.py): the reference's torch
`.pth` files and the JAX package's `.npz` models into the port's modules.

A published FRTM checkpoint holds only `refiner.*` keys (the backbone is not
part of it), so a full model is the refiner from the .pth plus a
torchvision-format backbone state dict. The port's modules keep the
reference's parameter names, so both are `load_state_dict` calls. The port's
own format is a `.pth` as well.

`load_jax_model` reads the `{"arch", "refiner"}` trees that
frtm_tpu/utils/checkpoints.py::save_pytree writes as `<name>.npz` (the
flattened leaves, "0" .. "n-1") beside a `<name>.treedef` sidecar, and that
frtm_tpu's evaluation CLIs read. The sidecar is a pickled jaxlib PyTreeDef:
unpickling it would import JAX, so it is never read. The tree is rebuilt
from the leaves instead: `jax.tree.flatten` visits dict keys in sorted order
at every level, a str leaf (the arch) is a 0-d `<U` array, and the
refiner's nesting is the one utils/convert.py::seg_network_from_jax reads.
"""
from pathlib import Path

import numpy as np
import torch

from ..config import autodetect_arch
from ..device import resolve_device
from ..models.resnet import RESNET_SPECS, ResNet, resnet_out_channels
from ..models.seg_network import LAYERS, SegNetwork
from .convert import seg_network_from_jax

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


def _jax_refiner_shapes(refiner: SegNetwork) -> dict:
    """frtm_tpu's refiner pytree for a SegNetwork of this shape, its leaves
    the JAX shapes (HWIO convolution weights): the nesting
    seg_network_from_jax reads."""
    sd = refiner.state_dict()

    def conv(name):
        o, i, kh, kw = sd[name + ".weight"].shape
        p = {"w": (kh, kw, i, o)}
        if name + ".bias" in sd:
            p["b"] = tuple(sd[name + ".bias"].shape)
        return p

    tree = {"tse": {}, "rrb1": {}, "rrb2": {}, "cab": {}}
    for L in refiner.layers:
        tree["tse"][L] = {j: conv(f"TSE.{L}.{k}") for k, j in (
            ("reduce.0", "reduce1"), ("reduce.2", "reduce2"), ("transform.0", "transform1"),
            ("transform.2", "transform2"), ("transform.4", "transform3"))}
        for rrb, R in (("rrb1", "RRB1"), ("rrb2", "RRB2")):
            p = {"conv1x1": conv(f"{R}.{L}.conv1x1"), "bb1": conv(f"{R}.{L}.bblock.0")}
            if f"{R}.{L}.bblock.1.weight" in sd:
                c = tuple(sd[f"{R}.{L}.bblock.1.weight"].shape)
                p["bn"] = {"scale": c, "bias": c, "mean": c, "var": c}
                p["bb2"] = conv(f"{R}.{L}.bblock.3")
            else:
                p["bb2"] = conv(f"{R}.{L}.bblock.2")
            tree[rrb][L] = p
        tree["cab"][L] = {"conv1": conv(f"CAB.{L}.convreluconv.0"),
                          "conv2": conv(f"CAB.{L}.convreluconv.2")}
    tree["up"] = {"conv1": conv("project.conv1"), "conv2": conv("project.conv2")}
    return tree


def _flatten_sorted(tree, prefix=()):
    """[(path, leaf)] in `jax.tree.flatten`'s order: dict keys sorted."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten_sorted(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def load_jax_model(path, device=None):
    """A frtm_tpu `.npz` model (save_pytree of {"arch", "refiner"}) -> (arch,
    SegNetwork). Every leaf's shape is checked against the port's refiner
    for that arch; a mismatch raises ValueError naming the first leaf that
    differs. The `.treedef` sidecar is not read."""
    path = Path(str(path).removesuffix(".npz") + ".npz")
    with np.load(path, allow_pickle=False) as z:
        leaves = [z[str(i)] for i in range(len(z.files))]
    if not leaves or leaves[0].dtype.kind != "U" or leaves[0].ndim != 0:
        raise ValueError(f"{path.name}: leaf 0 is not the arch name (a str); not a "
                         "frtm_tpu {arch, refiner} model")
    arch = str(leaves[0])
    if arch not in RESNET_SPECS:
        raise ValueError(f"{path.name}: unknown arch {arch!r}")
    channels = resnet_out_channels(arch)
    refiner = SegNetwork({L: channels[L] for L in LAYERS})
    expected = _flatten_sorted({"arch": (), "refiner": _jax_refiner_shapes(refiner)})
    for i, ((where, shape), leaf) in enumerate(zip(expected, leaves)):
        if i and (tuple(leaf.shape) != shape or leaf.dtype.kind != "f"):
            raise ValueError(f"{path.name}: leaf {i} ({'/'.join(where)}) is {leaf.dtype} "
                             f"{tuple(leaf.shape)}; the port's {arch} refiner has float "
                             f"{shape} there")
    if len(leaves) != len(expected):
        i = min(len(leaves), len(expected))
        raise ValueError(f"{path.name}: {len(leaves)} leaves where the port's {arch} "
                         f"refiner has {len(expected)}; leaf {i} is the first that differs")
    tree = {}
    for (where, _), leaf in zip(expected[1:], leaves[1:]):
        node = tree
        for k in where[1:-1]:
            node = node.setdefault(k, {})
        node[where[-1]] = leaf
    refiner.load_state_dict(seg_network_from_jax(tree))
    return arch, refiner.to(resolve_device(device)).eval()
