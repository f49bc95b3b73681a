#!/usr/bin/env python3
"""Closed-loop quality check of the PyTorch / CUDA port without any dataset
(the port of scripts/train_eval_synthetic.py): train the refiner on
synthetic moving-square scenes, then track HELD-OUT synthetic sequences with
the fused tracker and score them with the DAVIS J measure. It exercises the
trainer, checkpoints, the target-model solver and cache, the fused tracker
and the metrics end to end.

    python scripts/torch_train_eval_synthetic.py                # on the card
    python scripts/torch_train_eval_synthetic.py --dev cpu      # on the CPU
    python scripts/torch_train_eval_synthetic.py --compare-dtypes --min-j 0.8

The settings are the JAX script's: rn18 with seeded random weights, 8 epochs
of 48 samples at 120x160, batch 8, lr 1e-3, 5 augmentations; three held-out
10-frame sequences (seeds 1000-1002) tracked with eval-time target-model
settings. The batch order is drawn from RandomState(0). --compare-dtypes
also tracks in bfloat16 and prints the smallest float32-against-bfloat16
mask IoU over all frames; --min-j makes the exit code 1 where the mean J
falls below it. The last line of the output is a JSON summary. Without a
card, --dev cuda (the default) exits with an error; nothing runs on the CPU
unless --dev cpu asks for it.
"""
import argparse
import json
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def build_parser():
    ap = argparse.ArgumentParser(description="train and evaluate the port on synthetic data")
    ap.add_argument("--dev", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--train-samples", type=int, default=48)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--eval-seqs", type=int, default=3)
    ap.add_argument("--size", type=int, nargs=2, default=(120, 160))
    ap.add_argument("--min-j", type=float, default=None,
                    help="exit non-zero if mean J falls below this")
    ap.add_argument("--compare-dtypes", action="store_true",
                    help="also track with compute_dtype='bfloat16' and report the "
                         "float32-against-bfloat16 mask IoU per sequence")
    return ap


def mask_iou(a, b):
    u = (a | b).sum()
    return float((a & b).sum() / u) if u else 1.0


def main(argv=None):
    """Returns the summary dict (printed as the last line) and exits 1 under
    --min-j."""
    args = build_parser().parse_args(argv)

    import torch
    if args.dev == "cuda" and not torch.cuda.is_available():
        sys.exit("--dev cuda: no CUDA device is available; pass --dev cpu to run on the CPU")
    from frtm_tpu_torch.config import DiscConfig, TrackerConfig, eval_aug_params, \
        train_aug_params
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.data.training_datasets import SyntheticTrainingDataset
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.eval.davis import davis_jaccard_measure
    from frtm_tpu_torch.models.resnet import resnet_out_channels
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    from frtm_tpu_torch.runtime.trainer import TModelCache, Trainer, TrainerModel
    from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network

    dev = resolve_device(args.dev)
    arch = "resnet18"
    size = tuple(args.size)
    disc = DiscConfig(in_channels=resnet_out_channels(arch)["layer4"], c_channels=32,
                      init_iters=(3, 5, 5), update_iters=(5,), filter_reg=(1e-5, 1e-4),
                      precond=(1e-5, 1e-4), cg_forgetting_rate=75, memory_size=12,
                      train_skipping=4, pixel_weighting_method="none")
    train_cfg = TrackerConfig(feature_extractor=arch, num_aug=5, disc=disc,
                              aug_params=train_aug_params(5))
    backbone = init_resnet(arch, torch.Generator().manual_seed(0), device=dev)
    ch = {L: c for L, c in resnet_out_channels(arch).items() if L in train_cfg.refnet_layers}
    refiner = init_seg_network(ch, torch.Generator().manual_seed(1), device=dev)

    summary = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "epochs": args.epochs, "train_samples": args.train_samples,
               "batch_size": args.batch_size, "size": list(size)}
    with tempfile.TemporaryDirectory(prefix="frtm_synth_") as tmp:
        model = TrainerModel(train_cfg, backbone, refiner, TModelCache(Path(tmp) / "cache"),
                             device=dev)

        # a fixed pool of scenes across epochs (the target-model cache is then
        # valid, as with real datasets whose sequences are fixed)
        def dset():
            return SyntheticTrainingDataset(n_samples=args.train_samples, size=size,
                                            sample_size=3, seed=0)

        trainer = Trainer("synth", model, [dset], Path(tmp) / "ckpt", Path(tmp) / "log",
                          max_epochs=args.epochs, batch_size=args.batch_size, lr=1e-3,
                          load_latest=False, rng=np.random.RandomState(0))
        t0 = time.perf_counter()
        trainer.train()
        summary["train_s"] = time.perf_counter() - t0
        stats = [json.loads(line) for line in open(Path(tmp) / "log" / "synth" / "stats.jsonl")]
        summary["losses"] = [s["stats/loss"] for s in stats]

    # held-out sequences with eval-time settings
    eval_disc = replace(disc, pixel_weighting_method="hinge", init_iters=(5, 10, 10, 10),
                        update_iters=(5,), memory_size=20, train_skipping=8,
                        cg_forgetting_rate=750, filter_reg=(1e-4, 1e-2), precond=(1e-4, 1e-2))
    eval_cfg = replace(train_cfg, num_aug=5, disc=eval_disc, aug_params=eval_aug_params(5))
    trained = trainer.model.refiner
    tracker = BatchedSequenceTracker(eval_cfg, backbone, trained, extract_chunk=8, device=dev)
    tracker_bf16 = BatchedSequenceTracker(replace(eval_cfg, compute_dtype="bfloat16"), backbone,
                                          trained, extract_chunk=8, device=dev) \
        if args.compare_dtypes else None
    js, dtype_ious, fps = [], [], []
    for s in range(args.eval_seqs):
        seq = make_moving_square_sequence(n_frames=10, size=size, square=30, seed=1000 + s,
                                          name=f"eval{s}")
        outputs, seq_fps = tracker.run_sequence(seq)
        fps.append(seq_fps)
        # the DAVIS convention: the first and the last frame are not scored
        js.append(float(np.mean([davis_jaccard_measure(outputs[t] == 1,
                                                       seq.labels[t].squeeze() == 1)
                                 for t in range(1, len(seq) - 1)])))
        print(f"{seq.name}: J={js[-1]:.3f} ({seq_fps:.1f} fps)")
        if tracker_bf16 is not None:
            out_bf, _ = tracker_bf16.run_sequence(seq)
            dtype_ious.append(min(mask_iou(outputs[t] == 1, out_bf[t] == 1)
                                  for t in range(1, len(seq))))
            print(f"{seq.name}: f32-vs-bf16 mask IoU min over frames = {dtype_ious[-1]:.4f}")

    mean_j = float(np.mean(js))
    print(f"mean J over {args.eval_seqs} held-out sequences: {mean_j:.3f}")
    if dtype_ious:
        print(f"f32-vs-bf16 trained-refiner mask IoU: min {min(dtype_ious):.4f} over all "
              "frames/sequences")
    summary.update(J=js, mean_j=mean_j, fps=fps, min_j=args.min_j,
                   f32_vs_bf16_iou_min=min(dtype_ious) if dtype_ious else None)
    print(json.dumps(summary), flush=True)
    if args.min_j is not None and mean_j < args.min_j:
        print(f"FAIL: J {mean_j:.3f} < {args.min_j}")
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
