"""The small single-card pieces of the port, each against its frtm_tpu
counterpart on the CPU: `warp_perspective` and `remap` (ops/warp.py), `imwrite`
(data/image.py), the `.npz` model format (utils/checkpoints.py::load_jax_model
and the evaluation CLI on it), the torch.profiler trace helper
(utils/profiling.py::trace) and the demo script (scripts/torch_demo_synthetic.py).
"""
import argparse
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from frtm_tpu.data.image import imwrite as jax_imwrite
from frtm_tpu.models import init_seg_network, resnet_out_channels
from frtm_tpu.ops import warp as jax_warp
from frtm_tpu.utils.checkpoints import load_pytree, save_pytree
from frtm_tpu_torch import evaluate
from frtm_tpu_torch.data.image import imwrite
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
from frtm_tpu_torch.ops.warp import remap, warp_perspective
from frtm_tpu_torch.utils.checkpoints import load_jax_model
from frtm_tpu_torch.utils.convert import seg_network_from_jax
from frtm_tpu_torch.utils.profiling import trace
from test_torch_evaluate_cli import make_davis_tree
from test_torch_seg_network import _perturb_bn

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_fixtures" / "models" / "rn18_refiner.npz"
LAYERS = ("layer5", "layer4", "layer3", "layer2")


def _hwc(t):
    return t.permute(1, 2, 0).numpy()


_PERSPECTIVE = [np.array([[1.0, 0.1, 2.0], [0.05, 0.9, -1.0], [1e-3, -2e-3, 1.0]]),
                np.array([[0.9, -0.2, 5.0], [0.3, 1.1, -4.0], [-2e-3, 1e-3, 1.05]]),
                np.array([[1.2, 0.0, -3.0], [0.0, 0.8, 2.0], [0.0, 0.0, 1.0]])]


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("m", range(len(_PERSPECTIVE)))
def test_warp_perspective_matches_jax(rng, mode, m):
    """Bit-equal to frtm_tpu's warp_perspective (a projective map takes the
    kernel's direct variant on the card; here the plain version)."""
    src = (rng.rand(37, 51, 3) * 255).astype(np.float32)
    want = np.asarray(jax_warp.warp_perspective(jnp.asarray(src), _PERSPECTIVE[m], (30, 44),
                                                mode))
    got = warp_perspective(torch.from_numpy(np.ascontiguousarray(src.transpose(2, 0, 1))),
                           _PERSPECTIVE[m], (30, 44), mode)
    np.testing.assert_array_equal(_hwc(got), want)
    with pytest.raises(ValueError):
        warp_perspective(torch.zeros(1, 4, 4), np.eye(3)[:2], (4, 4))


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_remap_matches_jax(rng, mode):
    """Bit-equal to frtm_tpu's remap: maps reaching past every edge, float32
    planes and uint8 labels (nearest)."""
    src = (rng.rand(23, 31, 4) * 255).astype(np.float32)
    yy, xx = np.mgrid[0:19, 0:27].astype(np.float32)
    map_x = xx * 1.3 - 3.7 + 2.0 * np.sin(yy / 3.0)
    map_y = yy * 1.2 - 2.1 + 1.5 * np.cos(xx / 4.0)
    want = np.asarray(jax_warp.remap(jnp.asarray(src), map_x, map_y, mode))
    got = remap(torch.from_numpy(np.ascontiguousarray(src.transpose(2, 0, 1))), map_x, map_y,
                mode)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_hwc(got), want)
    if mode == "nearest":
        lbl = (rng.rand(23, 31, 1) > 0.5).astype(np.uint8)
        want = np.asarray(jax_warp.remap(jnp.asarray(lbl), map_x, map_y, mode))
        got = remap(torch.from_numpy(np.ascontiguousarray(lbl.transpose(2, 0, 1))),
                    torch.from_numpy(map_x), torch.from_numpy(map_y), mode)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(_hwc(got), want)


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 1), (13, 17, 3), (13, 17, 4)])
def test_imwrite_matches_jax(rng, tmp_path, shape):
    """PIL reads back the port's PNG as it reads frtm_tpu's (PIL-written)
    one: the same mode and pixels."""
    im = (rng.rand(*shape) * 255).astype(np.uint8)
    imwrite(tmp_path / "port.png", im)
    jax_imwrite(tmp_path / "jax.png", im)
    got, want = Image.open(tmp_path / "port.png"), Image.open(tmp_path / "jax.png")
    assert got.mode == want.mode == {2: "L", 1: "L", 3: "RGB", 4: "RGBA"}[
        1 if len(shape) == 2 else shape[2]]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got), im.squeeze())
    # JPEG: frtm_tpu's bytes (every case: test_torch_image_formats.py), RGBA
    # refused by both; other formats raise
    if shape[-1] == 4:
        with pytest.raises(ValueError, match="RGBA as JPEG"):
            imwrite(tmp_path / "port.jpg", im)
    else:
        imwrite(tmp_path / "port.jpg", im)
        jax_imwrite(tmp_path / "jax.jpg", im)
        assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()
    with pytest.raises(ValueError, match="PNG and JPEG only"):
        imwrite(tmp_path / "port.bmp", im)


def _refiner_tree(arch, seed=2):
    ch = {L: c for L, c in resnet_out_channels(arch).items() if L in LAYERS}
    tree = jax.tree.map(np.asarray, init_seg_network(jax.random.PRNGKey(seed), ch))
    return _perturb_bn(tree, np.random.RandomState(seed))


def _models(tmp_path, tree, arch="resnet18"):
    """The same refiner as a frtm_tpu .npz model and as a reference .pth."""
    save_pytree(tmp_path / "model", {"arch": arch, "refiner": tree})
    torch.save({"model": {"refiner." + k: v for k, v in seg_network_from_jax(tree).items()}},
               tmp_path / "model.pth")
    return tmp_path / "model.npz", tmp_path / "model.pth"


def _load(path):
    args = argparse.Namespace(model=str(path), backbone=None, dev="cpu")
    _, arch, refiner, _ = evaluate.load_models(args)
    return arch, refiner


def test_npz_model_gives_the_pth_logits(tmp_path):
    """A frtm_tpu-written .npz through the port's load_models gives the
    refiner of the .pth route on the same weights: equal logits."""
    npz, pth = _models(tmp_path, _refiner_tree("resnet18"))
    (arch_n, ref_n), (arch_p, ref_p) = _load(npz), _load(pth)
    assert arch_n == arch_p == "resnet18"
    g = torch.Generator().manual_seed(0)
    ch = resnet_out_channels("resnet18")
    sizes = {"layer5": (3, 4), "layer4": (6, 8), "layer3": (12, 16), "layer2": (24, 32)}
    feats = {L: torch.randn(2, ch[L], *sizes[L], generator=g) for L in LAYERS}
    scores = torch.randn(2, 1, 3, 4, generator=g)
    with torch.no_grad():
        got, want = ref_n(scores, feats, (90, 120)), ref_p(scores, feats, (90, 120))
    assert got.shape == (2, 1, 90, 120) and float(want.abs().max()) > 0
    assert torch.equal(got, want)


def test_npz_model_refused_where_it_does_not_fit(tmp_path):
    """A tree whose arch names other widths fails at its first differing
    leaf; so do an unknown arch and a file with no arch leaf."""
    tree = _refiner_tree("resnet18")
    npz, _ = _models(tmp_path, tree, arch="resnet101")
    with pytest.raises(ValueError, match=r"leaf \d+ \(refiner/tse/layer2/reduce1/w\)"):
        load_jax_model(npz, "cpu")
    with pytest.raises(SystemExit, match="not a reference-format .pth nor a frtm_tpu .npz"):
        _load(npz)
    save_pytree(tmp_path / "unknown", {"arch": "resnet7", "refiner": tree})
    with pytest.raises(ValueError, match="unknown arch"):
        load_jax_model(tmp_path / "unknown.npz", "cpu")
    save_pytree(tmp_path / "bare", tree)
    with pytest.raises(ValueError, match="arch"):
        load_jax_model(tmp_path / "bare.npz", "cpu")


def test_committed_npz_fixture_reads_as_frtm_tpu_reads_it():
    """The fixture scripts/make_torch_npz_fixture.py wrote (what the card's
    check loads, with no JAX there) is frtm_tpu's load_pytree's tree."""
    assert FIXTURE.stat().st_size < 2 * 2 ** 20
    arch, refiner = load_jax_model(FIXTURE, "cpu")
    tree = load_pytree(FIXTURE)
    assert arch == tree["arch"] == "resnet18"
    want = seg_network_from_jax(jax.tree.map(np.asarray, tree["refiner"]))
    got = refiner.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_cli_runs_on_an_npz_model(tmp_path):
    """The evaluation CLI on a fabricated DAVIS tree writes the same PNGs
    from the .npz model as from the .pth of the same weights."""
    seq = make_moving_square_sequence(n_frames=4, size=(96, 128), square=24, n_objects=2,
                                      seed=3, name="seq2")
    make_davis_tree(tmp_path / "DAVIS", [seq])
    npz, pth = _models(tmp_path, _refiner_tree("resnet18"))
    outs = {}
    for model in (npz, pth):
        out = tmp_path / model.suffix[1:]
        result = evaluate.main(["--model", str(model), "--dset", "dv2017val", "--davis",
                                str(tmp_path / "DAVIS"), "--output", str(out), "--dev", "cpu",
                                "--fast", "--dtype", "float32"])
        assert result["out_path"] == out.resolve() / "dv2017val-model_fast"
        outs[model.suffix] = sorted((result["out_path"] / "seq2").glob("*.png"))
    assert [p.name for p in outs[".npz"]] == [f"{n}.png" for n in seq.frame_names]
    for a, b in zip(outs[".npz"], outs[".pth"]):
        assert a.read_bytes() == b.read_bytes()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "trace") as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::matmul" in names or "aten::mm" in names


def test_demo_script_runs_on_the_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "torch_demo_synthetic", ROOT / "scripts" / "torch_demo_synthetic.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    res = demo.main(["--dev", "cpu", "--frames", "3", "--size", "64", "96",
                     "--out", str(tmp_path)])
    assert len(res["outputs"]) == 3 and res["fps"] > 0 and res["ious"][0] == 1.0
    assert sorted(p.name for p in tmp_path.glob("*.png")) == ["00000.png", "00001.png",
                                                             "00002.png"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            demo.main(["--frames", "2"])
