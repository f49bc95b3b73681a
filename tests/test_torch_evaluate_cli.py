"""The port's evaluation entry point, `frtm_tpu_torch.evaluate.main`, in
process on the CPU: a fabricated reference-format .pth and torchvision-format
backbone .pth, a miniature DAVIS tree (rn18, 96x128, 5 frames; one sequence
with one object, one with two), through the fused engine with and without
--pipeline, the host engine, and the sharded engine and --multihost (a
world of one process) against the fused engine's PNGs, down to the PNGs and
the J / F reports.

Held against frtm_tpu: its BatchedSequenceTracker.run_dataset, fed the same
two .pth files through its own loaders, on the same tree. Two things are
made equal that the two packages draw differently from a seed, so that the
comparison is of the entry point. The target model's starting weights: the
port's trackers are handed frtm_tpu's, converted. And the warps of the
first-frame augmentation: frtm_tpu's augmenter is built with backend="xla",
whose warps the port's kernel 3 reproduces on every value
(test_torch_augmenter.py); its default on a machine with OpenCV is cv2's
fixed-point warpAffine, which puts the augmented frames a few counts apart
and, through the ill-conditioned init, 1-3 % of these low-contrast labels.
The JAX tracker runs behind FreshBatches (test_torch_tracker.py).

The refiner is the port's seeded one with its head scaled, from the port's
own frame-1 logits, to a median of 0 and a spread of 0.5, so that the masks
hold both classes and every object keeps pixels in every frame. Its score
weights are NOT multiplied up as in test_torch_sequence_tracker.py: this
test runs the eval configuration's full --fast schedule (35 GN-CG iterations
at 96 channels, where those tests run 8 at 16), whose init is ill-conditioned
at this size, and a refiner that reads its scores 300 times louder turns that
into labels: frtm_tpu's own PNGs then move on 1.6 % of a frame when its
input features move by 1e-6 (the stem convolution scaled by 1 + 1e-6), and
the port's lie 2.3 % from them. As it is, frtm_tpu's own PNGs move on
0.08 % of a frame under that perturbation.

Bound: the port's PNGs differ from frtm_tpu's on under 0.5 % of a frame's
pixels (61 of 12,288), with frame 0 equal to the ground truth; measured at
most 0.23 % (fused and host engines alike), 3 times frtm_tpu's own
sensitivity and under half the bound.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from frtm_tpu.config import eval_config as jax_eval_config
from frtm_tpu.data.datasets import DAVISDataset as JaxDAVIS
from frtm_tpu.models.augmenter import ImageAugmenter as JaxAugmenter
from frtm_tpu.runtime.sequence_tracker import BatchedSequenceTracker as JaxFused
from frtm_tpu.utils import checkpoints as jax_ckpt
from frtm_tpu_torch import evaluate
from frtm_tpu_torch.config import eval_config
from frtm_tpu_torch.data.image import davis_palette, imwrite_indexed
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
from frtm_tpu_torch.models.resnet import resnet_out_channels
from frtm_tpu_torch.runtime import sequence_tracker, tracker
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from frtm_tpu_torch.utils.convert import disc_params_from_jax, init_resnet, init_seg_network
from test_torch_tracker import FreshBatches

torch.set_num_threads(2)

ARCH = "resnet18"
SIZE, SQUARE, FRAMES = (96, 128), 24, 5
HEAD_SPREAD = 0.5


def make_davis_tree(root: Path, seqs, year="2017"):
    """A DAVIS-layout tree: JPEG frames, indexed-PNG annotations, the split list."""
    (root / "ImageSets" / year).mkdir(parents=True)
    (root / "ImageSets" / year / "val.txt").write_text("".join(s.name + "\n" for s in seqs))
    for seq in seqs:
        jd = root / "JPEGImages" / "480p" / seq.name
        ad = root / "Annotations" / "480p" / seq.name
        jd.mkdir(parents=True)
        ad.mkdir(parents=True)
        for name, im, lb in zip(seq.frame_names, seq.images, seq.labels):
            Image.fromarray(im).save(jd / f"{name}.jpg", quality=95)
            imwrite_indexed(ad / f"{name}.png", lb)


class World:
    def __init__(self, root: Path):
        self.seqs = [make_moving_square_sequence(n_frames=FRAMES, size=SIZE, square=SQUARE,
                                                 n_objects=n, seed=2 + n, name=f"seq{n}")
                     for n in (1, 2)]
        self.davis = root / "DAVIS"
        make_davis_tree(self.davis, self.seqs)

        cfg = eval_config(ARCH, fast=True)
        ch = {L: c for L, c in resnet_out_channels(ARCH).items() if L in cfg.refnet_layers}
        backbone = init_resnet(ARCH, torch.Generator().manual_seed(1), "cpu")
        refiner = init_seg_network(ch, torch.Generator().manual_seed(2), device="cpu")
        self.backbone_pth = root / "rn18_backbone.pth"
        torch.save(backbone.state_dict(), self.backbone_pth)

        # the target model's starting weights: frtm_tpu's, for both packages
        jcfg = jax_eval_config(ARCH, fast=True, compute_dtype="float32")
        jbackbone = jax_ckpt.load_backbone(self.backbone_pth, ARCH)
        self.model_pth = root / "rn18_fake.pth"
        self._save(refiner)
        probe = JaxFused(jcfg, jbackbone, jax_ckpt.load_reference_model(self.model_pth)[1],
                         extract_chunk=16)
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

        self.jax_out = root / "jax_results"
        self.jax_run(self.davis, self.jax_out)

    def jax_run(self, davis, out):
        """frtm_tpu's run_dataset from the same two files on a DAVIS tree."""
        jcfg = jax_eval_config(ARCH, fast=True, compute_dtype="float32")
        arch, jrefiner = jax_ckpt.load_reference_model(self.model_pth)
        assert arch == ARCH
        jt = JaxFused(jcfg, jax_ckpt.load_backbone(self.backbone_pth, ARCH), jrefiner,
                      extract_chunk=16)
        jt.augmenter = FreshBatches(JaxAugmenter(jcfg.aug_params, backend="xla"))
        jt.run_dataset(JaxDAVIS(path=davis, year="2017", split="val"), out)

    def _save(self, refiner):
        """The reference's trainer checkpoint: refiner.* keys under 'model'."""
        torch.save({"model": {"refiner." + k: v for k, v in refiner.state_dict().items()},
                    "epoch": 260}, self.model_pth)

    def args(self, out, *extra, davis=None):
        return ["--model", str(self.model_pth), "--backbone", str(self.backbone_pth),
                "--dset", "dv2017val", "--davis", str(davis or self.davis), "--output", str(out),
                "--dev", "cpu", "--fast", "--dtype", "float32", *extra]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("cli"))


def _read(path):
    return np.array(Image.open(path))


def _run(world, monkeypatch, out, *extra, davis=None):
    monkeypatch.setattr(sequence_tracker, "init_disc_params", lambda *a, **k: world.p0)
    monkeypatch.setattr(tracker, "init_disc_params", lambda *a, **k: world.p0)
    result = evaluate.main(world.args(out, *extra, davis=davis))
    assert result["out_path"] == Path(out).resolve() / "dv2017val-rn18_fake_fast"
    return result


def _check_against_jax(world, res_dir, jax_out=None):
    worst = 0.0
    for seq in world.seqs:
        pngs = sorted((res_dir / seq.name).glob("*.png"))
        assert [p.stem for p in pngs] == seq.frame_names
        np.testing.assert_array_equal(_read(pngs[0]), seq.labels[0][..., 0])
        for p in pngs:
            got, want = _read(p), _read((jax_out or world.jax_out) / seq.name / p.name)
            assert Image.open(p).mode == "P"
            worst = max(worst, float(np.mean(got != want)))
        # every object and the background hold pixels in the tracked frames
        for p in pngs[1:]:
            counts = [int((_read(p) == i).sum()) for i in range(len(seq.obj_ids) + 1)]
            assert min(counts) >= 10, (seq.name, p.name, counts)
    print(f"worst label mismatch against frtm_tpu: {worst:.5f}")
    assert worst < 0.005, worst
    return worst


def _check_reports(res_dir, result):
    for measure in ("J", "F"):
        lines = (res_dir / f"evaluation-{measure}.txt").read_text().splitlines()
        assert lines[0] == "1/2: seq1: 1 object" and "2/2: seq2: 2 objects" in lines
        assert lines[-1].startswith(f"{measure}: {result[measure]:.3f}, recall: ")
        assert 0.0 <= result[measure] <= 1.0


@pytest.mark.parametrize("engine", ["fused", "host"])
def test_cli_matches_jax_run_dataset(world, monkeypatch, tmp_path, capsys, engine):
    result = _run(world, monkeypatch, tmp_path / "out", "--engine", engine)
    _check_against_jax(world, result["out_path"])
    _check_reports(result["out_path"], result)
    out = capsys.readouterr().out
    assert "Evaluating dv2017val" in out and "Average frame rate:" in out
    assert "Computing J-scores" in out and "Computing F-scores" in out
    assert "(ex-augment)" not in out and result["fps"] > 0


def test_cli_pipeline_writes_the_same_pngs(world, monkeypatch, tmp_path, capsys):
    plain = _run(world, monkeypatch, tmp_path / "plain")
    capsys.readouterr()
    piped = _run(world, monkeypatch, tmp_path / "piped", "--pipeline")
    out = capsys.readouterr().out
    assert out.count("(ex-augment)") == 2 and "Pipelined dataset pass:" in out
    assert "(10 frames / " in out
    for seq in world.seqs:
        for name in seq.frame_names:
            a = (plain["out_path"] / seq.name / f"{name}.png").read_bytes()
            b = (piped["out_path"] / seq.name / f"{name}.png").read_bytes()
            assert a == b, (seq.name, name)
    _check_against_jax(world, piped["out_path"])
    assert (piped["J"], piped["F"]) == (plain["J"], plain["F"])


def test_cli_restart_and_random_backbone(world, monkeypatch, tmp_path, capsys):
    """--restart skips the sequences before the named one; without --backbone
    the seeded random backbone is used, with the JAX CLI's warning. bfloat16 is
    the default --dtype."""
    args = [a for a in world.args(tmp_path / "out", "--restart", "seq2")
            if a not in ("--backbone", str(world.backbone_pth), "--dtype", "float32")]
    monkeypatch.setattr(sequence_tracker, "init_disc_params", lambda *a, **k: world.p0)
    built = []
    real = sequence_tracker.BatchedSequenceTracker.__init__

    def spy(self, cfg, *a, **k):
        built.append((cfg.compute_dtype, k.get("extract_chunk")))
        real(self, cfg, *a, **k)

    monkeypatch.setattr(sequence_tracker.BatchedSequenceTracker, "__init__", spy)
    with pytest.raises(FileNotFoundError):      # seq1 was not tracked, so scoring misses it
        evaluate.main(args)
    out = capsys.readouterr().out
    assert "WARNING: no --backbone weights given; using random backbone" in out
    assert "seq2:" in out and "seq1:" not in out
    assert built == [("bfloat16", 16)]
    res_dir = (tmp_path / "out").resolve() / "dv2017val-rn18_fake_fast"
    assert len(list((res_dir / "seq2").glob("*.png"))) == FRAMES
    assert not (res_dir / "seq1").exists()


@pytest.fixture(scope="module")
def fused_run(world, tmp_path_factory):
    """The fused engine's run, the reference of the multi-device flags."""
    with pytest.MonkeyPatch.context() as mp:
        return _run(world, mp, tmp_path_factory.mktemp("fused") / "out")


@pytest.mark.parametrize("extra", [["--engine", "sharded"],
                                   ["--engine", "sharded", "--multihost"], ["--multihost"]])
def test_cli_sharded_and_multihost_write_the_fused_pngs(world, fused_run, monkeypatch, tmp_path,
                                                        capsys, extra):
    """`--engine sharded` tracks each group of sequences in one pass (here
    two groups of one: one and two objects), `--multihost` in a world of one
    process changes nothing: the fused engine's PNGs, byte for byte (a group
    whose sequences have as many objects as its width gives the fused
    tracker's labels: test_torch_multi_sequence*.py), and its J and F."""
    result = _run(world, monkeypatch, tmp_path / "out", *extra)
    out = capsys.readouterr().out
    assert ("Sharded dataset pass:" in out) == ("sharded" in extra)
    assert "multihost: process" not in out
    for seq in world.seqs:
        for name in seq.frame_names:
            png = f"{seq.name}/{name}.png"
            assert (result["out_path"] / png).read_bytes() == \
                (fused_run["out_path"] / png).read_bytes(), png
    _check_reports(result["out_path"], result)
    assert (result["J"], result["F"]) == (fused_run["J"], fused_run["F"])


def test_cli_reads_2bit_annotations(world, fused_run, monkeypatch, tmp_path):
    """The tree's annotations saved again by PIL with a 3-colour palette,
    which it writes at 2 bits a pixel (the port once raised on them): the
    port's PNGs within the bound of frtm_tpu's run_dataset on that tree, and
    byte for byte those of its own run on the 8-bit tree."""
    davis = tmp_path / "DAVIS2"
    shutil.copytree(world.davis, davis)
    for path in sorted((davis / "Annotations").rglob("*.png")):
        labels = np.array(Image.open(path))
        im = Image.fromarray(labels, "P")
        im.putpalette(davis_palette[:3].ravel().tolist())
        im.save(path)
        assert path.read_bytes()[24:26] == bytes([2, 3])        # IHDR: 2-bit palette
    world.jax_run(davis, tmp_path / "jax_results")
    result = _run(world, monkeypatch, tmp_path / "out", davis=davis)
    _check_against_jax(world, result["out_path"], tmp_path / "jax_results")
    for seq in world.seqs:
        for name in seq.frame_names:
            png = f"{seq.name}/{name}.png"
            assert (result["out_path"] / png).read_bytes() == \
                (fused_run["out_path"] / png).read_bytes(), png
            np.testing.assert_array_equal(_read(tmp_path / "jax_results" / png),
                                          _read(world.jax_out / png))


def test_cli_refuses_what_it_cannot_do(world, tmp_path, capsys):
    if not torch.cuda.is_available():
        args = [a if a != "cpu" else "cuda" for a in world.args(tmp_path / "out")]
        with pytest.raises(SystemExit) as e:
            evaluate.main(args)
        assert e.value.code not in (0, None) and "no CUDA device is available" in str(e.value.code)
        with pytest.raises(SystemExit) as e:
            evaluate.main(args + ["--engine", "sharded"])
        assert "no CUDA device is available" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        evaluate.main(world.args(tmp_path / "out", "--spatial", "2"))
    assert e.value.code not in (0, None) and "--spatial 2 needs --multihost" in str(e.value.code)
    with pytest.raises(SystemExit) as e:        # a world of one process is no multiple of 2
        evaluate.main(world.args(tmp_path / "out", "--spatial", "2", "--multihost"))
    assert "a world of 1 processes is not a multiple of 2" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        evaluate.main(world.args(tmp_path / "out")[2:] + ["--model", str(tmp_path / "no.pth")])
    assert "not found" in str(e.value.code)
    (tmp_path / "model.npz").write_bytes(b"")
    with pytest.raises(SystemExit) as e:
        evaluate.main(world.args(tmp_path / "out")[2:] + ["--model", str(tmp_path / "model.npz")])
    assert "not a reference-format .pth nor a frtm_tpu .npz model" in str(e.value.code)
    with pytest.raises(SystemExit):
        evaluate.main(["--help"])
    help_text = capsys.readouterr().out
    for flag in ("--model", "--dset", "--dev", "--fast", "--davis", "--yt2018", "--output",
                 "--backbone", "--dtype", "--restart", "--engine", "--pipeline",
                 "--aug-compact", "--spatial", "--multihost", "--dist-backend"):
        assert flag in help_text
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("extra, dev, backend", [((), "cuda", "nccl"),
                                                  (("--dist-backend", "gloo"), "cuda", "gloo"),
                                                  ((), "cpu", "gloo")])
def test_cli_spatial_joins_nccl_on_cards(world, monkeypatch, tmp_path, extra, dev, backend):
    """`--spatial 2 --multihost` joins NCCL on cards, so its exchanges go card
    to card; gloo where `--dist-backend gloo` asks for it (ranks sharing a
    card) and on the CPU."""
    from frtm_tpu_torch.parallel import distributed

    class Joined(Exception):
        pass

    def join(*args, backend="gloo", device=None, **kwargs):
        raise Joined(backend, device)

    monkeypatch.setattr(evaluate, "load_models",
                        lambda args: (world.model_pth, ARCH, None, None))
    monkeypatch.setattr(distributed, "init_distributed", join)
    args = [a if a != "cpu" else dev for a in world.args(tmp_path / "out")]
    with pytest.raises(Joined) as e:
        evaluate.main(args + ["--spatial", "2", "--multihost", *extra])
    assert e.value.args == (backend, dev)


SPATIAL_CHILD = """
import sys
import torch
torch.set_num_threads(2)
from frtm_tpu_torch.parallel import init_distributed
from frtm_tpu_torch.runtime import sequence_tracker
p0 = torch.load(sys.argv[3], weights_only=False)
sequence_tracker.init_disc_params = lambda *a, **k: p0
init_distributed(sys.argv[2], 2, int(sys.argv[1]), timeout_s=300)
from frtm_tpu_torch import evaluate
evaluate.main(sys.argv[4:])
"""


def test_cli_spatial_two_processes(world, fused_run, tmp_path):
    """`--spatial 2 --multihost` in a gloo world of two processes on the
    CPU: one frame's height split over both, their PNGs within the tracker
    bound (0.5 % of a frame) of the one-process fused run (measured:
    equal), the scores written by rank 0 alone."""
    torch.save(world.p0, tmp_path / "p0.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join([str(Path(__file__).resolve().parents[1]),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    args = world.args(tmp_path / "two", "--spatial", "2", "--multihost")
    children = [subprocess.Popen([sys.executable, "-c", SPATIAL_CHILD, str(rank),
                                  f"file://{tmp_path / 'rendezvous'}", str(tmp_path / "p0.pt"),
                                  *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True, env=env, cwd=tmp_path)
                for rank in range(2)]
    try:
        outs = [child.communicate(timeout=600)[0] for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    for rank, (child, out) in enumerate(zip(children, outs)):
        assert child.returncode == 0, (rank, out[-3000:])
    assert "Computing J-scores" in outs[0] and "Computing J-scores" not in outs[1]
    assert "multihost: process" not in outs[0]      # one group of two tracks every sequence
    two = tmp_path.resolve() / "two" / fused_run["out_path"].name
    worst = 0.0
    for seq in world.seqs:
        for name in seq.frame_names:
            got = _read(two / seq.name / f"{name}.png")
            worst = max(worst, float(np.mean(got != _read(fused_run["out_path"] / seq.name /
                                                          f"{name}.png"))))
    assert worst < 0.005, worst
    for measure in ("J", "F"):
        assert (two / f"evaluation-{measure}.txt").read_text().splitlines()[0] == \
            "1/2: seq1: 1 object"
