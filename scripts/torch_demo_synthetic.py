#!/usr/bin/env python3
"""End-to-end demo of the PyTorch / CUDA port on a synthetic moving-square
sequence (the port of scripts/demo_synthetic.py): runs the host-loop tracker
(augment -> GN-CG init -> per-frame classify / refine / merge / update) with
seeded random weights, writes indexed PNGs and prints per-frame IoU and fps.

    python scripts/torch_demo_synthetic.py                # on the card
    python scripts/torch_demo_synthetic.py --dev cpu      # on the CPU

It needs no dataset. Without a card, `--dev cuda` (the default) exits with
an error; nothing runs on the CPU unless --dev cpu asks for it.
"""
import argparse
import sys
import tempfile
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description="FRTM port demo on a synthetic sequence")
    ap.add_argument("--dev", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(120, 160))
    ap.add_argument("--objects", type=int, default=1)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.image import imwrite_indexed
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.models.resnet import resnet_out_channels
    from frtm_tpu_torch.runtime.tracker import Tracker
    from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network

    if args.dev == "cuda" and not torch.cuda.is_available():
        sys.exit("--dev cuda: no CUDA device is available; pass --dev cpu to run on the CPU")
    dev = resolve_device(args.dev)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    seq = make_moving_square_sequence(n_frames=args.frames, size=tuple(args.size),
                                      square=28, n_objects=args.objects)
    cfg = eval_config(args.arch, fast=True, num_aug=3)
    cfg = replace(cfg, disc=replace(cfg.disc, init_iters=(3, 5), update_iters=(3,),
                                    memory_size=16, c_channels=32, train_skipping=2))
    backbone = init_resnet(args.arch, torch.Generator().manual_seed(1), dev)
    ch = {L: c for L, c in resnet_out_channels(args.arch).items() if L in cfg.refnet_layers}
    refiner = init_seg_network(ch, torch.Generator().manual_seed(2), device=dev)
    tracker = Tracker(cfg, backbone, refiner, device=dev)

    outputs, fps = tracker.run_sequence(seq)
    out_dir = Path(args.out or tempfile.mkdtemp(prefix="frtm_torch_demo_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"sequence '{seq.name}': {len(outputs)} frames @ {fps:.2f} fps")
    ious = []
    for t, (out, name) in enumerate(zip(outputs, seq.frame_names)):
        imwrite_indexed(out_dir / f"{name}.png", out)
        gt = seq.labels[t].squeeze() > 0
        pred = out > 0
        ious.append(float((gt & pred).sum() / max((gt | pred).sum(), 1)))
        print(f"  frame {t}: IoU(all objects)={ious[-1]:.3f}")
    print("wrote PNGs to", out_dir)
    return {"outputs": outputs, "fps": fps, "ious": ious, "out_dir": out_dir}


if __name__ == "__main__":
    main()
