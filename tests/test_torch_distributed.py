"""The port's multi-process plumbing (frtm_tpu_torch/parallel/distributed.py,
mesh.py) on the CPU: init_distributed's no-op and its refusal to fall back,
process_slice and batch_rows against frtm_tpu's, the mesh of a world of one,
and a real run of two processes in a gloo group (rendezvous through a file
under the test's temporary directory, so that runs side by side never share
a port): `python -m frtm_tpu_torch.evaluate --engine sharded --multihost
--dev cpu` on a 3-sequence DAVIS-layout tree writes the PNGs of a
one-process `--engine sharded` run, byte for byte, and only rank 0 scores.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from frtm_tpu.parallel import distributed as jax_dist
from frtm_tpu_torch import evaluate
from frtm_tpu_torch.data.image import imread
from frtm_tpu_torch.parallel import (barrier, batch_rows, global_mesh, init_distributed,
                                     local_mesh, make_mesh, process_slice)
from test_torch_evaluate_cli import make_davis_tree
from test_torch_multi_sequence_port import World, sequence

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")

CHILD = """
import sys
import torch
torch.set_num_threads(2)
from frtm_tpu_torch.parallel import init_distributed
init_distributed(sys.argv[2], 2, int(sys.argv[1]), timeout_s=300)
from frtm_tpu_torch import evaluate
evaluate.main(sys.argv[3:])
"""


@pytest.fixture
def no_torchrun(monkeypatch):
    for name in TORCHRUN_VARS:
        monkeypatch.delenv(name, raising=False)


def test_init_distributed_without_a_world_is_a_no_op(no_torchrun):
    assert init_distributed() == (0, 1)
    assert not dist.is_initialized()
    barrier("nothing to wait for")
    assert process_slice(5) == list(range(5)) and batch_rows(4) == (0, 4)


def test_a_declared_world_that_cannot_meet_raises(no_torchrun, tmp_path, monkeypatch):
    """Rank 0 of two, and rank 1 never comes: the rendezvous times out and
    raises; a world declared without its rank raises at once."""
    with pytest.raises(RuntimeError):
        init_distributed(f"file://{tmp_path / 'rendezvous'}", 2, 0, timeout_s=2)
    assert not dist.is_initialized()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator, world size and rank"):
        init_distributed()


@pytest.mark.parametrize("n_items", [0, 1, 7, 16])
@pytest.mark.parametrize("n_proc", [1, 2, 3, 8])
def test_process_slice_and_batch_rows_match_frtm_tpu(n_items, n_proc):
    for pid in range(n_proc):
        assert process_slice(n_items, pid, n_proc) == \
            jax_dist.process_slice(n_items, pid, n_proc)
        if n_items % n_proc == 0:
            assert batch_rows(n_items, pid, n_proc) == jax_dist.batch_rows(n_items, pid, n_proc)
        else:
            with pytest.raises(ValueError, match="not divisible"):
                batch_rows(n_items, pid, n_proc)


def test_meshes_of_a_world_of_one(no_torchrun):
    for mesh in (make_mesh(device="cpu"), make_mesh(1, device="cpu"), local_mesh("cpu")):
        assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
        assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2, device="cpu")


def test_meshes_default_to_the_card(no_torchrun):
    """Without an argument a mesh is on this process's card, and a machine
    without one raises: the CPU only where it is asked for."""
    if torch.cuda.is_available():
        assert make_mesh().device == torch.device("cuda", torch.cuda.current_device())
        return
    for make in (make_mesh, local_mesh, global_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_two_processes_write_one_process_pngs(no_torchrun, tmp_path, capsys):
    world = World()
    seqs = [sequence(5, 2, 70 + i, f"seq{i}") for i in range(3)]
    make_davis_tree(tmp_path / "DAVIS", seqs)
    backbone_pth, model_pth = tmp_path / "rn18_backbone.pth", tmp_path / "rn18_fake.pth"
    torch.save(world.backbone.state_dict(), backbone_pth)
    torch.save({"model": {"refiner." + k: v for k, v in world.refiners[()].state_dict().items()}},
               model_pth)

    def args(out):
        return ["--model", str(model_pth), "--backbone", str(backbone_pth), "--dset",
                "dv2017val", "--davis", str(tmp_path / "DAVIS"), "--output", str(out),
                "--dev", "cpu", "--fast", "--dtype", "float32", "--engine", "sharded"]

    one = evaluate.main(args(tmp_path / "one"))
    capsys.readouterr()
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    rendezvous = f"file://{tmp_path / 'rendezvous'}"
    children = [subprocess.Popen([sys.executable, "-c", CHILD, str(rank), rendezvous,
                                  *args(tmp_path / "two"), "--multihost"],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                 env=env, cwd=tmp_path)
                for rank in range(2)]
    outs = [child.communicate(timeout=600)[0] for child in children]
    for rank, (child, out) in enumerate(zip(children, outs)):
        assert child.returncode == 0, (rank, out[-3000:])
    assert "multihost: process 0/2 tracking 2/3 sequences" in outs[0]
    assert "multihost: process 1/2 tracking 1/3 sequences" in outs[1]
    assert "Computing J-scores" in outs[0] and "Computing J-scores" not in outs[1]
    assert "seq1: 5 frames written" in outs[1] and "seq1:" not in outs[0].split("Computing")[0]

    res_one, res_two = one["out_path"], tmp_path.resolve() / "two" / one["out_path"].name
    assert (res_two / "evaluation-J.txt").read_text() == (res_one / "evaluation-J.txt").read_text()
    foreground = 0
    for seq in seqs:
        for t, f in enumerate(seq.frame_names):
            png = res_two / seq.name / f"{f}.png"
            assert png.read_bytes() == (res_one / seq.name / png.name).read_bytes(), png
            foreground += int(np.count_nonzero(imread(png))) if t else 0
    assert foreground > 0       # the tracked frames are not all background
