#!/usr/bin/env python3
"""Height sharding across cards: one frame's rows split over every process
of a torchrun world, one process a card, over NCCL (gloo with --dev cpu).

    python -m torch.distributed.run --nproc-per-node 2 scripts/torch_spatial_cards.py
    python -m torch.distributed.run --nproc-per-node 2 scripts/torch_spatial_cards.py \
        --dev cpu --arch resnet18 --size 96 128 --frames 5

chip_smoke.py's weights (seeded, the head scaled as its `decode` phase
scales it) and its `spatial` phase's sequence (rn101, 480x854, 17 frames,
two squares) by default. Each rank, on its own card:
- the pyramid in float32 and bfloat16 against the unsharded pyramid it
  computes itself, the largest difference over each level's peak;
- make_spatial_frame_step in float32 and bfloat16 against the step on this
  process alone, and the seconds a frame of both (median of 5, the card
  synchronised);
- the bfloat16 fused tracker with mesh= against the tracker without one:
  the largest share of a frame on which the labels part, the exchanges,
  gathers and all-reduces a frame with their bytes, the seconds of a
  sequence each way, peak memory.
It fails where the float32 pyramid or frame step lies more than 1e-5 (of
the peak) from the unsharded one, or where the ranks' labels or target
models differ. Rank 0 prints one JSON line with every rank's numbers, and
the card's name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def synchronize(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def seconds(fn, dev, repeats=5):
    times = []
    for _ in range(repeats):
        synchronize(dev)
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dev", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="resnet101")
    ap.add_argument("--size", type=int, nargs=2, default=(480, 854))
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--out", default=None, help="also write the JSON line here (rank 0)")
    args = ap.parse_args()
    import chip_smoke as cs
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.models.discriminator import DiscParams
    from frtm_tpu_torch.models.resnet import level_heights
    from frtm_tpu_torch.ops import halo
    from frtm_tpu_torch.ops.conv import compute_copy
    from frtm_tpu_torch.parallel import (init_distributed, local_mesh, make_spatial_frame_step,
                                         make_spatial_mesh)
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    from frtm_tpu_torch.runtime.tracker import Tracker

    dev = args.dev
    resolve_device(dev)
    rank, world = init_distributed(backend="nccl" if dev == "cuda" else "gloo", device=dev)
    if dev == "cpu":
        torch.set_num_threads(2)
    mesh = make_spatial_mesh(world, device=dev)
    H, W = args.size
    cfg = eval_config(args.arch)
    seq = make_moving_square_sequence(n_frames=args.frames, size=(H, W), square=H // 4,
                                      n_objects=2, seed=cs.SPATIAL_SEED, name="spatial")
    host = Tracker(cfg, *cs.build_models(args.arch, cfg, dev), device=dev)
    decode = cs.frame1_decoder(host, seq)
    logits = decode()
    cs.scale_head(host.refiner, float(logits.median()), float(logits.std()))
    backbone, refiner = host.backbone, host.refiner
    del host, decode, logits
    out = {"rank": rank, "world": world, "backend": dist.get_backend(), "size": [H, W],
           "arch": args.arch, "frames": args.frames}

    layers = ("layer5", "layer4", "layer3", "layer2")
    heights = level_heights(H)
    frames = torch.from_numpy(np.stack(seq.images[1:9])).to(dev).permute(0, 3, 1, 2)
    out["pyramid_of_peak"] = {}
    for dtype in ("float32", "bfloat16"):
        t = getattr(torch, dtype)
        net = backbone if t == torch.float32 else compute_copy(backbone, t)
        ref = net.extract_features(frames, output_layers=layers, out_dtype=t)
        got = net.extract_features(frames, output_layers=layers, out_dtype=t, mesh=mesh)
        out["pyramid_of_peak"][dtype] = {
            L: float((halo.gather_rows(got[L], heights[L], mesh).float() - ref[L].float())
                     .abs().max()) / float(ref[L].float().abs().max()) for L in layers}
        del ref, got

    def tracker(dtype, m=None):
        return BatchedSequenceTracker(replace(cfg, compute_dtype=dtype), backbone, refiner,
                                      extract_chunk=16, device=dev, mesh=m)

    plain, sharded = tracker("bfloat16"), tracker("bfloat16", mesh)
    plain.run_sequence(seq)                          # first launches
    synchronize(dev)
    t0 = time.perf_counter()
    labels_plain, _ = plain.run_sequence(seq)
    synchronize(dev)
    wall_plain = time.perf_counter() - t0
    sharded.run_sequence(seq)
    mesh.traffic.clear()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    synchronize(dev)
    t0 = time.perf_counter()
    labels, _ = sharded.run_sequence(seq)
    synchronize(dev)
    wall = time.perf_counter() - t0
    n = len(seq)
    p = plain.last_models[0]
    disc = DiscParams(p.project[:1].contiguous(), p.filter[:1].contiguous())
    filters = sharded.last_models[0].filter
    out["tracker_bfloat16"] = {
        "label_gap_max": max(float(np.mean(a != b)) for a, b in zip(labels, labels_plain)),
        "seconds_sequence": {"one_rank": wall_plain, "world": wall},
        "per_frame": {k: v / n for k, v in mesh.traffic.items()},
        "peak_memory": torch.cuda.max_memory_allocated() if dev == "cuda" else None}
    del plain, sharded

    frame = frames[:1]
    out["frame_step"] = {}
    for dtype in ("float32", "bfloat16"):
        t = getattr(torch, dtype)
        one, split = (make_spatial_frame_step(cfg, local_mesh(dev), t),
                      make_spatial_frame_step(cfg, mesh, t))
        a, b = one(backbone, refiner, disc, frame), split(backbone, refiner, disc, frame)
        mesh.traffic.clear()
        split(backbone, refiner, disc, frame)
        out["frame_step"][dtype] = {
            "max_abs_err": float((a - b).abs().max()), "traffic": dict(mesh.traffic),
            "seconds": {"one_rank": seconds(lambda: one(backbone, refiner, disc, frame), dev),
                        "world": seconds(lambda: split(backbone, refiner, disc, frame), dev)}}

    # every rank's numbers, labels and filters on rank 0
    mine = {"out": out, "labels": np.stack(labels), "filters": filters.cpu()}
    every = [None] * world
    dist.all_gather_object(every, mine)
    checks = {
        "pyramid_float32_within_1e-5_of_peak": all(
            v <= 1e-5 for r in every for v in r["out"]["pyramid_of_peak"]["float32"].values()),
        "frame_step_float32_within_1e-5": all(
            r["out"]["frame_step"]["float32"]["max_abs_err"] <= 1e-5 for r in every),
        "ranks_labels_equal": all(np.array_equal(r["labels"], every[0]["labels"])
                                  for r in every),
        "ranks_filters_bit_equal": all(torch.equal(r["filters"], every[0]["filters"])
                                       for r in every)}
    if rank == 0:
        card = None
        if dev == "cuda":
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip().splitlines()
        line = json.dumps({"checks": checks, "card": card, "ranks": [r["out"] for r in every]})
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(line + "\n")
    dist.barrier()
    dist.destroy_process_group()
    if not all(checks.values()):
        sys.exit(f"spatial across cards: {[k for k, v in checks.items() if not v]}")


if __name__ == "__main__":
    main()
