"""The port's YouTube-VOS entry point, `frtm_tpu_torch.evaluate_ytvos.main`,
in process on the CPU (--dev cpu --dtype float32): a fabricated
reference-format .pth and torchvision-format backbone .pth, a miniature
YouTube-VOS 2018 tree made with PIL (valid/meta.json with each object's
first frame, annotations at the entry frames only, the all-frames JPEG
dump; rn18, 48x64, 6 frames; one sequence whose second object enters at
frame 2, one with a single object), through the deferred-merge fused tracker
with the legacy configuration, down to the PNGs.

Held against frtm_tpu's BatchedSequenceTracker(merge_mode="deferred") with
the same legacy configuration, fed the same two files through its own
loaders on the same tree. As in test_torch_evaluate_cli.py, the target
model's starting weights are frtm_tpu's, converted, and frtm_tpu's augmenter
takes its backend="xla" warps (which kernel 3 reproduces on every value),
behind FreshBatches. The refiner's head is scaled to a spread of 0.5 on the
port's own frame-1 logits, and its score weights are left as they are (the
full schedule's init is ill-conditioned at this size).

Bound: the port's PNGs differ from frtm_tpu's on under 1 % of a frame's
pixels; measured 0.62 % (seqA, frame 5, after object 2 entered; seqB 0.03 %).
The DAVIS CLI's PNGs are held to 0.5 % (PERF.md section 2), but this
configuration is more sensitive: the legacy "thresh" update and the full
schedule on a 14 px object that enters mid-sequence. The yardstick is
frtm_tpu's own sensitivity on this tree: when its input features move by
1e-6 (the stem convolution scaled by 1 + 1e-6) its own PNGs move on up to
0.49 % of a frame (0.26 % at frames 3-4, 0.49 % at frame 5, the frames where
the port's gap lies). 1 % is twice that.
"""
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from frtm_tpu.config import eval_config as jax_eval_config
from frtm_tpu.data.datasets import YouTubeVOSDataset as JaxYTVOS
from frtm_tpu.models.augmenter import ImageAugmenter as JaxAugmenter
from frtm_tpu.runtime.sequence_tracker import BatchedSequenceTracker as JaxFused
from frtm_tpu.utils import checkpoints as jax_ckpt
from frtm_tpu_torch import evaluate_ytvos
from frtm_tpu_torch.data.image import imwrite_indexed
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
from frtm_tpu_torch.models.resnet import resnet_out_channels
from frtm_tpu_torch.runtime import sequence_tracker
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from frtm_tpu_torch.utils.convert import disc_params_from_jax, init_resnet, init_seg_network
from test_torch_tracker import FreshBatches

torch.set_num_threads(2)

ARCH = "resnet18"
SIZE, SQUARE, FRAMES = (48, 64), 14, 6
HEAD_SPREAD = 0.5
STARTS = {"seqA": {1: "00000", 2: "00002"}, "seqB": {1: "00000"}}


def make_ytvos_tree(root: Path, seqs, starts):
    """valid/{meta.json, Annotations} and valid_all_frames/JPEGImages, the
    layout the valid_all_frames split reads; an object's label appears in
    the annotation of its own first frame only."""
    meta = {"videos": {}}
    for seq in seqs:
        jd = root / "valid_all_frames" / "JPEGImages" / seq.name
        ad = root / "valid" / "Annotations" / seq.name
        jd.mkdir(parents=True)
        ad.mkdir(parents=True)
        for name, im in zip(seq.frame_names, seq.images):
            Image.fromarray(im).save(jd / f"{name}.jpg", quality=95)
        st = starts[seq.name]
        meta["videos"][seq.name] = {"objects": {
            str(o): {"frames": seq.frame_names[seq.frame_names.index(f):]} for o, f in st.items()}}
        for t, name in enumerate(seq.frame_names):
            entering = [o for o, f in st.items() if f == name]
            if entering:
                lb = np.where(np.isin(seq.labels[t], entering), seq.labels[t], 0)
                imwrite_indexed(ad / f"{name}.png", lb.astype(np.uint8))
    (root / "valid" / "meta.json").write_text(json.dumps(meta))


class World:
    def __init__(self, root: Path):
        self.seqs = [make_moving_square_sequence(n_frames=FRAMES, size=SIZE, square=SQUARE,
                                                 n_objects=n, seed=s, name=name)
                     for n, s, name in ((2, 3, "seqA"), (1, 5, "seqB"))]
        self.ytvos = root / "ytvos2018"
        make_ytvos_tree(self.ytvos, self.seqs, STARTS)

        cfg = evaluate_ytvos.legacy_config(ARCH, "float32")
        ch = {L: c for L, c in resnet_out_channels(ARCH).items() if L in cfg.refnet_layers}
        backbone = init_resnet(ARCH, torch.Generator().manual_seed(1), "cpu")
        refiner = init_seg_network(ch, torch.Generator().manual_seed(2), device="cpu")
        self.backbone_pth = root / "rn18_backbone.pth"
        torch.save(backbone.state_dict(), self.backbone_pth)
        self.model_pth = root / "rn18_ytvos.pth"
        self._save(refiner)

        jcfg = jax_eval_config(ARCH, fast=False, compute_dtype="float32")
        jcfg = replace(jcfg, disc=replace(jcfg.disc, cg_forgetting_rate=75,
                                          update_method="thresh", clamp_output=False))
        jbackbone = jax_ckpt.load_backbone(self.backbone_pth, ARCH)
        probe = JaxFused(jcfg, jbackbone, jax_ckpt.load_reference_model(self.model_pth)[1])
        p0 = probe._disc_params0[jcfg.disc.layer]
        self.p0 = disc_params_from_jax(np.asarray(p0.project), np.asarray(p0.filter))

        # scale the head from the port's own frame-1 logits (two objects)
        vol, _ = BatchedSequenceTracker(cfg, backbone, refiner, merge_mode="deferred",
                                        device="cpu", disc_params0=self.p0).run_sequence(
            make_moving_square_sequence(n_frames=2, size=SIZE, square=SQUARE, n_objects=2,
                                        seed=4), soft=True)
        y = np.clip(vol[1].astype(np.float64), 1e-12, 1 - 1e-12)
        logits = np.log(y) - np.log1p(-y)
        with torch.no_grad():
            conv2 = refiner.project.conv2
            conv2.weight.mul_(HEAD_SPREAD / float(logits.std()))
            conv2.bias.sub_(float(np.median(logits))).mul_(HEAD_SPREAD / float(logits.std()))
        self._save(refiner)

        # frtm_tpu's deferred-merge tracker from the same files on the same tree
        arch, jrefiner = jax_ckpt.load_reference_model(self.model_pth)
        jt = JaxFused(jcfg, jbackbone, jrefiner, merge_mode="deferred")
        jt.augmenter = FreshBatches(JaxAugmenter(jcfg.aug_params, backend="xla"))
        self.jax_out = root / "jax_results"
        jt.run_dataset(JaxYTVOS(path=self.ytvos, year="2018", split="valid_all_frames"),
                       self.jax_out)

    def _save(self, refiner):
        torch.save({"model": {"refiner." + k: v for k, v in refiner.state_dict().items()},
                    "epoch": 260}, self.model_pth)

    def args(self, out, *extra):
        return ["--model", str(self.model_pth), "--backbone", str(self.backbone_pth),
                "--yt2018", str(self.ytvos), "--output", str(out), "--dev", "cpu",
                "--dtype", "float32", *extra]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("ytvos"))


def _read(path):
    return np.array(Image.open(path))


def test_cli_matches_jax_deferred_tracker(world, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(sequence_tracker, "init_disc_params", lambda *a, **k: world.p0)
    result = evaluate_ytvos.main(world.args(tmp_path / "out"))
    res = (tmp_path / "out").resolve() / "ytvos2018valid_all_frames" / "Annotations"
    assert result["out_path"] == res and result["fps"] > 0
    tracker = result["tracker"]
    assert tracker.merge_mode == "deferred" and tracker.cfg.compute_dtype == "float32"
    disc = tracker.cfg.disc
    assert (disc.update_method, disc.cg_forgetting_rate, disc.clamp_output,
            disc.init_iters) == ("thresh", 75, False, (5, 10, 10, 10, 10))
    out = capsys.readouterr().out
    assert "Evaluating ytvos2018valid_all_frames" in out and "Average frame rate:" in out
    worst = 0.0
    for seq in world.seqs:
        pngs = sorted((res / seq.name).glob("*.png"))
        assert [p.stem for p in pngs] == seq.frame_names
        for p in pngs:
            assert Image.open(p).mode == "P"
            worst = max(worst, float(np.mean(_read(p) != _read(world.jax_out / seq.name / p.name))))
        # the ground truth at the start frames: frame 0 holds only the objects
        # that start there, object 2 of seqA enters at frame 2
        want0 = seq.labels[0][..., 0].copy()
        want0[~np.isin(want0, [o for o, f in STARTS[seq.name].items() if f == "00000"])] = 0
        np.testing.assert_array_equal(_read(pngs[0]), want0)
        for p in pngs[1:]:
            counts = [int((_read(p) == i).sum()) for i in range(2)]
            assert min(counts) >= 10, (seq.name, p.name, counts)
    got2 = _read(res / "seqA" / "00002.png")
    entering = world.seqs[0].labels[2][..., 0] == 2
    assert ((got2 == 2) & entering).sum() >= 0.9 * entering.sum()
    assert worst < 0.01, worst


def test_cli_sequences_and_refusals(world, monkeypatch, tmp_path, capsys):
    """--sequences tracks a subset; a card that is absent, a missing model and
    a .npz file that holds no model are refused; the flags are the JAX
    script's."""
    monkeypatch.setattr(sequence_tracker, "init_disc_params", lambda *a, **k: world.p0)
    evaluate_ytvos.main(world.args(tmp_path / "sub", "--sequences", "seqB"))
    res = (tmp_path / "sub").resolve() / "ytvos2018valid_all_frames" / "Annotations"
    assert sorted(p.name for p in res.iterdir()) == ["seqB"]
    if not torch.cuda.is_available():
        args = [a if a != "cpu" else "cuda" for a in world.args(tmp_path / "out")]
        with pytest.raises(SystemExit) as e:
            evaluate_ytvos.main(args)
        assert "no CUDA device is available" in str(e.value.code)
    (tmp_path / "model.npz").write_bytes(b"")
    for model, message in ((tmp_path / "no.pth", "not found"),
                           (tmp_path / "model.npz",
                            "not a reference-format .pth nor a frtm_tpu .npz model")):
        args = world.args(tmp_path / "out")
        args[1] = str(model)
        with pytest.raises(SystemExit) as e:
            evaluate_ytvos.main(args)
        assert message in str(e.value.code)
    with pytest.raises(SystemExit):
        evaluate_ytvos.main(["--help"])
    help_text = capsys.readouterr().out
    for flag in ("--model", "--yt2018", "--output", "--backbone", "--dev", "--dtype",
                 "--sequences"):
        assert flag in help_text
    assert not (tmp_path / "out").exists()
