"""The port's ResNet pyramid against frtm_tpu's extract_features with the same
weights, carried over by frtm_tpu_torch.utils.convert."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.models import extract_features, init_resnet
from frtm_tpu_torch.models.resnet import ResNet, resnet_out_channels
from frtm_tpu_torch.utils.convert import init_resnet as torch_init_resnet
from frtm_tpu_torch.utils.convert import resnet_from_jax


def _perturb_bn(tree, rng):
    """Non-identity BN statistics so the folded BN is exercised."""
    def visit(node):
        if isinstance(node, dict) and "mean" in node:
            c = node["mean"].shape[0]
            return dict(scale=rng.rand(c).astype(np.float32) + 0.5,
                        bias=rng.randn(c).astype(np.float32) * 0.1,
                        mean=rng.randn(c).astype(np.float32) * 0.1,
                        var=rng.rand(c).astype(np.float32) + 0.5)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node
    return visit(tree)


def test_resnet18_pyramid_matches_jax(rng):
    tree = _perturb_bn(jax.tree.map(np.asarray, init_resnet(jax.random.PRNGKey(3), "resnet18")),
                       rng)
    images = (rng.rand(2, 64, 96, 3) * 255).astype(np.float32)
    want = extract_features(jax.tree.map(jnp.asarray, tree), jnp.asarray(images), "resnet18")

    net = ResNet("resnet18")
    net.load_state_dict(resnet_from_jax(tree))
    got = net.extract_features(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert set(got) == set(want) == {f"layer{i}" for i in range(1, 6)}
    for L, w in want.items():
        g = got[L].permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        assert g.shape[-1] == resnet_out_channels("resnet18")[L]
        # measured max relative-to-peak diff 3e-7 (layer5)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("arch", ["resnet50", "resnet101"])
def test_bottleneck_state_dict_round_trip(arch):
    """JAX trees convert to a complete, torchvision-named state dict."""
    net = torch_init_resnet(arch, torch.Generator().manual_seed(0), device="cpu")
    sd = net.state_dict()
    assert "layer3.22.conv3.weight" in sd or arch == "resnet50"
    assert sd["layer1.0.downsample.0.weight"].shape == (256, 64, 1, 1)
    assert all(k.startswith(("conv1", "bn1", "layer")) for k in sd)
