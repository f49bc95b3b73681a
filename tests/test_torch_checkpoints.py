"""The function that carries weights across: one reference-format .pth goes
to frtm_tpu.utils.checkpoints and to frtm_tpu_torch.utils.checkpoints, and
the two models then compute the same thing.

The refiner .pth is made as tests/test_checkpoint_conversion.py makes it
(256 and 1024 input channels at layer4, inside {"model": ...} and as a raw
state dict), with its convolutions scaled by their fan-in and its batch-norm
statistics perturbed so that the logits stay of order 1 and the BN fold is
exercised. Bound: logits within 1e-5 of their peak; measured 8.4e-7 (rn18
widths) and 1.04e-6 (rn101 widths). Likewise a torchvision-format rn18 backbone
and its five feature maps: bound 1e-4 of each map's peak, measured at most
5.3e-7 (layer5).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from frtm_tpu.config import autodetect_arch as jax_autodetect_arch
from frtm_tpu.models import extract_features as jax_extract_features
from frtm_tpu.models import seg_network_apply as jax_seg_network_apply
from frtm_tpu.utils import checkpoints as jax_ckpt
from frtm_tpu_torch.config import autodetect_arch
from frtm_tpu_torch.models.resnet import ResNet, resnet_out_channels
from frtm_tpu_torch.models.seg_network import SegNetwork
from frtm_tpu_torch.utils import checkpoints as ckpt
from frtm_tpu_torch.utils.convert import init_resnet
from test_checkpoint_conversion import _refiner_sd

torch.set_num_threads(2)


def _scaled_refiner_sd(rng, in_ch):
    sd = _refiner_sd(rng, in_ch)
    for k, v in sd.items():
        if v.dim() == 4:
            sd[k] = v / np.sqrt(v.shape[1] * v.shape[2] * v.shape[3])
        elif k.endswith(".bias") and ".bblock.1." not in k:
            sd[k] = v * 0.1
        elif k.endswith("running_var") or k.endswith("bblock.1.weight"):
            sd[k] = torch.from_numpy(rng.rand(*v.shape).astype(np.float32) + 0.5)
        elif k.endswith("running_mean") or k.endswith("bblock.1.bias"):
            sd[k] = torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1)
    return sd


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.mark.parametrize("in_ch,arch", [(1024, "resnet101"), (256, "resnet18")])
@pytest.mark.parametrize("wrapped", [True, False], ids=["trainer_checkpoint", "raw_state_dict"])
def test_reference_pth_loads_alike_in_both_packages(tmp_path, rng, in_ch, arch, wrapped):
    sd = _scaled_refiner_sd(rng, in_ch)
    path = tmp_path / "ckpt.pth"
    torch.save({"model": sd, "epoch": 260, "optimizer": {}, "scheduler": {}} if wrapped else sd,
               path)

    loaded = ckpt.load_torch_state_dict(path)
    assert set(loaded) == set(sd) and all(torch.equal(loaded[k], sd[k]) for k in sd)
    assert autodetect_arch(loaded) == jax_autodetect_arch(jax_ckpt.load_torch_state_dict(path))
    got_arch, refiner = ckpt.load_reference_model(path, device="cpu")
    want_arch, jrefiner = jax_ckpt.load_reference_model(path)
    assert got_arch == want_arch == arch
    assert isinstance(refiner, SegNetwork) and not refiner.training
    # every tensor of the file is in the module, unchanged
    state = refiner.state_dict()
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(state[k[len("refiner."):]], v), k

    chans = {"layer5": in_ch * 2, "layer4": in_ch, "layer3": in_ch // 2, "layer2": in_ch // 4}
    sizes = {"layer5": (2, 3), "layer4": (4, 6), "layer3": (8, 12), "layer2": (16, 24)}
    feats = {L: rng.randn(2, *sizes[L], c).astype(np.float32) for L, c in chans.items()}
    scores = rng.randn(2, 4, 6, 1).astype(np.float32)
    want = np.asarray(jax_seg_network_apply(
        jrefiner, jnp.asarray(scores), {L: jnp.asarray(v) for L, v in feats.items()}, (60, 90)))
    got = refiner(_nchw(scores), {L: _nchw(v) for L, v in feats.items()}, (60, 90))
    got = got.permute(0, 2, 3, 1).numpy()
    peak = np.abs(want).max()
    assert got.shape == want.shape == (2, 60, 90, 1) and 0.01 < peak < 100
    assert np.abs(got - want).max() <= 1e-5 * peak, np.abs(got - want).max() / peak


def test_autodetect_arch_refuses_other_widths(rng):
    sd = {"refiner.TSE.layer4.reduce.0.weight": torch.zeros(32, 512, 1, 1)}
    with pytest.raises(ValueError, match="512"):
        autodetect_arch(sd)
    with pytest.raises(ValueError):
        jax_autodetect_arch({k: v.numpy() for k, v in sd.items()})


def test_torchvision_backbone_pth_loads_alike_in_both_packages(tmp_path, rng):
    """A torchvision-format rn18 state dict (with the classifier head and the
    BN step counters such a file has) through both loaders, then features."""
    net = init_resnet("resnet18", torch.Generator().manual_seed(4), device="cpu")
    sd = dict(net.state_dict())
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.rand(*sd[k].shape).astype(np.float32) + 0.5)
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
        elif k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.randn(*sd[k].shape).astype(np.float32) * 0.1)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    path = tmp_path / "rn18.pth"
    torch.save(sd, path)

    backbone = ckpt.load_backbone(path, "resnet18", device="cpu")
    assert isinstance(backbone, ResNet) and not backbone.training
    same = ckpt.load_backbone(sd, "resnet18", device="cpu")         # the dict itself
    assert all(torch.equal(a, b) for a, b in zip(backbone.state_dict().values(),
                                                 same.state_dict().values()))
    jparams = jax_ckpt.load_backbone(path, "resnet18")
    images = (rng.rand(2, 64, 96, 3) * 255).astype(np.float32)
    want = jax_extract_features(jparams, jnp.asarray(images), "resnet18")
    got = backbone.extract_features(_nchw(images))
    assert set(got) == set(want)
    for L, w in want.items():
        g, w = got[L].permute(0, 2, 3, 1).numpy(), np.asarray(w)
        assert g.shape == w.shape and g.shape[-1] == resnet_out_channels("resnet18")[L]
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (L, np.abs(g - w).max())
    with pytest.raises(RuntimeError):           # a state dict of another architecture
        ckpt.load_backbone(sd, "resnet101", device="cpu")
