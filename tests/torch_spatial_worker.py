"""One rank of the height-sharding tests' gloo worlds on the CPU
(tests/test_torch_spatial.py runs it as a child process; it imports torch
and the port, never JAX):

    python tests/torch_spatial_worker.py ops WORKDIR RANK WORLD
    python tests/torch_spatial_worker.py models WORKDIR RANK WORLD

The ranks meet through WORKDIR/rendezvous. `ops` runs every case of OPS on a
spatial group of the whole world, each beside its unsharded self in this
process, and writes WORKDIR/ops{WORLD}_{RANK}.pt. `models` (a world of 4)
reads WORKDIR/inputs.pt (weights, images, sequences' augment batches) and
writes WORKDIR/models{RANK}.pt: the pyramid and the frame step on a group of
4 and on the plain world mesh, the frame step on a 2 x 2 (data x spatial)
mesh and each sample alone in this process, and the fused trackers (one
object online, two objects deferred, multilayer) on a group of 4 beside the
same trackers without a mesh, with their init and final filters.
"""
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from frtm_tpu_torch.config import eval_config  # noqa: E402
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence  # noqa: E402
from frtm_tpu_torch.models.discriminator import DiscParams  # noqa: E402
from frtm_tpu_torch.models.resnet import ResNet, resnet_out_channels  # noqa: E402
from frtm_tpu_torch.models.seg_network import SegNetwork  # noqa: E402
from frtm_tpu_torch.ops import halo  # noqa: E402
from frtm_tpu_torch.parallel import (init_distributed, local_mesh, make_mesh,  # noqa: E402
                                     make_spatial_extract, make_spatial_frame_step,
                                     make_spatial_mesh)
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker  # noqa: E402

ARCH = "resnet18"
TINY = dict(init_iters=(2,), update_iters=(2,), memory_size=4, c_channels=8, train_skipping=2)
SEQ_SIZE, SQUARE = (64, 96), 16


def tiny_config(multilayer=False):
    """tests/test_spatial.py's tracker configuration."""
    cfg = eval_config(ARCH, fast=True, num_aug=2)
    cfg = replace(cfg, disc=replace(cfg.disc, **TINY))
    return replace(cfg, disc_layers=("layer4", "layer3")) if multilayer else cfg


def step_config():
    """tests/test_spatial.py's frame-step configuration."""
    cfg = eval_config(ARCH, fast=True)
    return replace(cfg, disc=replace(cfg.disc, c_channels=16))


# the trackers' sequences: (name, frames, objects, seed, multilayer, merge mode)
TRACKS = (("fused", 5, 1, 3, False, "online"), ("deferred", 4, 2, 5, False, "deferred"),
          ("multilayer", 4, 1, 6, True, "online"))


def sequence_args(name):
    """make_moving_square_sequence's arguments (both packages have it) for
    the tracker case `name`."""
    _, frames, objects, seed, _, _ = next(t for t in TRACKS if t[0] == name)
    return dict(n_frames=frames, size=SEQ_SIZE, square=SQUARE, n_objects=objects, seed=seed)


def track_sequence(name):
    return make_moving_square_sequence(**sequence_args(name))


def _rand(shape, seed, lo=-1.0, hi=1.0):
    g = np.random.RandomState(seed)
    return torch.from_numpy((g.rand(*shape) * (hi - lo) + lo).astype(np.float32))


def ops_cases(n):
    """(name, global input height, input whole?, fn(x, H, mesh), input
    channels) of the
    halo unit cases at a group of n: strided and unstrided convolutions,
    the max pool at its -inf border, resizes, kernels 1 and 2, the spatial
    mean; at even heights, one-row shards and heights that do not divide."""
    w7, w3 = _rand((8, 3, 7, 7), 1), _rand((5, 4, 3, 3), 2)
    w1, b1 = _rand((6, 4, 1, 1), 3), _rand((6,), 4)
    wk2, bk2 = _rand((1, 4, 3, 3), 5), _rand((1,), 6)
    H = 12 * n
    return [
        ("stem_7x7_s2", H, False, lambda x, H, m: halo.conv2d(x, w7, stride=2, H=H, mesh=m), 3),
        ("stem_7x7_s2_whole_input", H, True,
         lambda x, H, m: halo.conv2d(x, w7, stride=2, H=H, mesh=m), 3),
        ("conv_7x7_s2_two_row_shards", 2 * n, False,
         lambda x, H, m: halo.conv2d(x, w7, stride=2, H=H, mesh=m), 3),
        ("conv_3x3_s2", H, False, lambda x, H, m: halo.conv2d(x, w3, stride=2, H=H, mesh=m), 4),
        ("conv_3x3_s1", H, False, lambda x, H, m: halo.conv2d(x, w3, H=H, mesh=m), 4),
        ("conv_3x3_one_row_shards", n, False, lambda x, H, m: halo.conv2d(x, w3, H=H, mesh=m),
         4),
        ("conv_3x3_indivisible", H + 1, True, lambda x, H, m: halo.conv2d(x, w3, H=H, mesh=m),
         4),
        ("conv_1x1_s2", H, False,
         lambda x, H, m: halo.conv2d(x, w1, b1, stride=2, H=H, mesh=m), 4),
        ("maxpool_3x3_s2", H, False, lambda x, H, m: halo.max_pool_3x3_s2(x, H=H, mesh=m), 4),
        ("maxpool_one_row_output", 2 * n, False,
         lambda x, H, m: halo.max_pool_3x3_s2(x, H=H, mesh=m), 4),
        ("resize_up_2x", H, False,
         lambda x, H, m: halo.resize(x, (2 * H, 20), "bilinear", H, m), 4),
        ("resize_down", 2 * H, False,
         lambda x, H, m: halo.resize(x, (H, 7), "bilinear", H, m), 4),
        ("resize_whole_to_rows", 5, True,
         lambda x, H, m: halo.resize(x, (12 * n, 16), "bilinear", H, m), 4),
        ("resize_pooled_to_rows", 1, True,
         lambda x, H, m: halo.resize(x, (4 * n, 16), "bilinear", H, m), 4),
        ("resize_rows_to_indivisible", H, False,
         lambda x, H, m: halo.resize(x, (H + 1, 16), "bilinear", H, m), 4),
        ("resize_bicubic_up", H, False,
         lambda x, H, m: halo.resize(x, (2 * H, 32), "bicubic", H, m), 4),
        ("resize_width_only", H, False,
         lambda x, H, m: halo.resize(x, (H, 32), "bilinear", H, m), 4),
        ("pyrup", H, False, lambda x, H, m: halo.pyr_up_bicubic(x, H, m), 4),
        ("pyrup_one_row_shards", n, False, lambda x, H, m: halo.pyr_up_bicubic(x, H, m), 4),
        ("pyrup_indivisible_input", 2 * n + 1, True,
         lambda x, H, m: halo.pyr_up_bicubic(x, H, m), 4),
        ("conv3x3_cout1", H, False, lambda x, H, m: halo.conv3x3_cout1(x, wk2, bk2, H, m), 4),
        ("conv3x3_cout1_one_row_shards", n, False,
         lambda x, H, m: halo.conv3x3_cout1(x, wk2, bk2, H, m), 4),
        ("conv3x3_cout1_indivisible", H + 1, True,
         lambda x, H, m: halo.conv3x3_cout1(x, wk2, bk2, H, m), 4),
        ("spatial_mean", H, False, lambda x, H, m: halo.spatial_mean(x, H, m), 4),
    ]


def run_ops(mesh):
    """Per case: (unsharded output, this rank's sharded output gathered
    whole, the input height and whether the input was whole)."""
    out = {}
    for i, (name, H, whole, fn, cin) in enumerate(ops_cases(mesh.size)):
        x = _rand((2, cin, H, 11), 100 + i, lo=-3.0, hi=-0.5 if "maxpool" in name else 3.0)
        want = fn(x, H, None)
        xin = x if whole else halo.take_rows(x, H, mesh)
        got = fn(xin, H, mesh)
        got = halo.gather_rows(got, want.shape[-2], mesh) if want.shape[-2] > 1 else got
        out[name] = {"want": want, "got": got, "H": H, "whole": whole,
                     "local_in": int(xin.shape[-2])}
    out["traffic"] = dict(mesh.traffic)
    return out


def load_models(weights, refiner_key="refiner"):
    """The backbone and a refiner of inputs.pt: "refiner" (the frame
    step's), "refiner_trk" or "refiner_ml" (the trackers')."""
    backbone = ResNet(ARCH)
    backbone.load_state_dict(weights["backbone"])
    ch = {L: c for L, c in resnet_out_channels(ARCH).items() if L in step_config().refnet_layers}
    refiner = SegNetwork(ch, in_channels=2 if refiner_key == "refiner_ml" else 1)
    refiner.load_state_dict(weights[refiner_key])
    return backbone, refiner


def run_trackers(inputs, mesh):
    out = {}
    for name, _, _, _, multilayer, merge_mode in TRACKS:
        backbone, refiner = load_models(inputs, "refiner_ml" if multilayer else "refiner_trk")
        cfg = tiny_config(multilayer)
        seq = track_sequence(name)
        batches = inputs["aug_batches"][name]
        runs = {}
        for tag, m in (("sharded", mesh), ("single", None)):
            tracker = BatchedSequenceTracker(cfg, backbone, refiner, extract_chunk=4,
                                             merge_mode=merge_mode, device="cpu",
                                             disc_params0=inputs["p0_ml" if multilayer
                                                                 else "p0"],
                                             mesh=m)
            inits = []
            init = tracker._init_objects_dense

            def recorded(images, labels, init=init, inits=inits):
                models = init(images, labels)
                inits.append(_filters(models[0]))     # the loop updates them in place
                return models

            tracker._init_objects_dense = recorded
            labels, _ = tracker.run_sequence(seq, aug_batches=batches)
            params = tracker.last_models[0]
            runs[tag] = {"labels": np.stack(labels),
                         "init_filters": inits[0],
                         "filters": _filters(params)}
        out[name] = runs
    return out


def _filters(params):
    if isinstance(params, dict):
        return {L: p.filter.clone() for L, p in params.items()}
    return {"": params.filter.clone()}


def run_models(workdir, world):
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    backbone, refiner = load_models(inputs)
    images = inputs["images"]                       # (2, 3, 128, 96)
    cfg = step_config()
    disc = DiscParams(inputs["disc_project"], inputs["disc_filter"])
    sp4 = make_spatial_mesh(4, device="cpu")
    flat = make_mesh(world, device="cpu")           # the world as one group, no data axis
    dpsp = make_spatial_mesh(2, 2, device="cpu")
    out = {"extract": make_spatial_extract(ARCH, sp4, cfg.refnet_layers)(backbone, images[:1]),
           "extract_single": backbone.extract_features(images[:1],
                                                       output_layers=cfg.refnet_layers),
           "step": make_spatial_frame_step(cfg, sp4)(backbone, refiner, disc, images[:1]),
           "step_flat": make_spatial_frame_step(cfg, flat)(backbone, refiner, disc, images[:1]),
           "step_dpsp": make_spatial_frame_step(cfg, dpsp)(backbone, refiner, disc, images),
           "step_traffic": dict(sp4.traffic)}
    one = local_mesh("cpu")                         # this process alone
    out["step_single"] = [make_spatial_frame_step(cfg, one)(backbone, refiner, disc,
                                                            images[b:b + 1])
                          for b in range(images.shape[0])]
    out["trackers"] = run_trackers(inputs, sp4)
    return out


def main(mode, workdir, rank, world):
    torch.set_num_threads(2)
    workdir = Path(workdir)
    init_distributed(f"file://{workdir / f'rendezvous_{mode}{world}'}", int(world), int(rank),
                     timeout_s=300)
    if mode == "ops":
        out = run_ops(make_spatial_mesh(int(world), device="cpu"))
        torch.save(out, workdir / f"ops{world}_{rank}.pt")
    else:
        torch.save(run_models(workdir, int(world)), workdir / f"models{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:5])
