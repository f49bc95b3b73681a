"""Train the refinement network: the port's counterpart of the JAX package's
train.py, with its command-line surface.

    python -m frtm_tpu_torch.train sess01 --ftext resnet101 --dset all \\
        --dv2017 /data/DAVIS --yt2018 /data/ytvos2018 \\
        --backbone resnet101.pth --workspace /data/workspace

Only the refiner trains; the backbone is frozen and the target models are
solved per sample and cached under <workspace>/tmodels_cache/. The settings
are the reference's: rn101 (or rn18) at 480x854, batch 16, 15-way
augmentation, target models with c = 32 on layer4 and no pixel weighting,
AMSGrad lr 1e-3 with L2 decay 1e-5, StepLR(127, 0.1), 260 epochs, DAVIS x8
repeats and 4000 YouTube-VOS samples per epoch. Checkpoints go to
<workspace>/checkpoints/<name>/ and a run resumes from the newest;
statistics go to <workspace>/logs/<name>/stats.jsonl.

It runs on the card (`--dev cuda`, the default) and exits with an error where
there is none; `--dev cpu` must be asked for. `--dp` and `--multihost` are
parsed and refused: they are not ported yet.
"""
import argparse
import random
import sys
from pathlib import Path

import numpy as np
import torch

NOT_PORTED = ("{what} is not ported to frtm_tpu_torch yet: data-parallel and multi-host "
              "training are ROADMAP.md queue item 7")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m frtm_tpu_torch.train",
                                 description="Train FRTM (PyTorch / CUDA port)")
    ap.add_argument("name", type=str, help="training session name")
    ap.add_argument("--ftext", type=str, default="resnet101",
                    choices=["resnet101", "resnet18"], help="feature extractor")
    ap.add_argument("--dset", type=str, default="all",
                    choices=["all", "yt2018", "dv2017", "synthetic"],
                    help="training datasets (synthetic = data-free smoke run)")
    ap.add_argument("--dev", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="device to run on; cuda needs a card, there is no fallback")
    ap.add_argument("--dv2017", type=str, default="/data/DAVIS")
    ap.add_argument("--yt2018", type=str, default="/data/ytvos2018")
    ap.add_argument("--workspace", type=str, default="workspace",
                    help="checkpoints/logs/tmodel-cache root")
    ap.add_argument("--backbone", type=str, default=None,
                    help="torchvision-format resnet .pth")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--max-epochs", type=int, default=260)
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel over N devices (not ported yet)")
    ap.add_argument("--multihost", action="store_true",
                    help="train over every host's devices (not ported yet)")
    return ap


def train_config(arch: str):
    """The reference training configuration (train.py:56-72)."""
    from .config import DiscConfig, TrackerConfig, train_aug_params
    from .models.resnet import resnet_out_channels
    disc = DiscConfig(
        in_channels=resnet_out_channels(arch)["layer4"], c_channels=32,
        init_iters=(5, 10, 10, 10, 10), update_iters=(10,),
        filter_reg=(1e-5, 1e-4), precond=(1e-5, 1e-4), precond_lr=0.1,
        cg_forgetting_rate=75, memory_size=20, train_skipping=8,
        learning_rate=0.1, pixel_weighting_method="none", layer="layer4")
    return TrackerConfig(feature_extractor=arch, num_aug=15, disc=disc,
                         aug_params=train_aug_params(15))


def main(argv=None):
    """Run the training; returns the Trainer."""
    args = build_parser().parse_args(argv)
    for flag, what in ((args.dp, "--dp"), (args.multihost, "--multihost")):
        if flag:
            sys.exit(NOT_PORTED.format(what=what))
    if args.dev == "cuda" and not torch.cuda.is_available():
        sys.exit("--dev cuda: no CUDA device is available (torch.cuda.is_available() is "
                 "false); nothing runs on the CPU unless --dev cpu asks for it")

    from .data.training_datasets import (DAVISTrainingDataset, SyntheticTrainingDataset,
                                         YouTubeVOSTrainingDataset)
    from .models.resnet import resnet_out_channels
    from .runtime.trainer import TModelCache, Trainer, TrainerModel
    from .utils import checkpoints as ckpt
    from .utils.convert import init_resnet, init_seg_network

    arch = args.ftext
    cfg = train_config(arch)
    if args.backbone:
        backbone = ckpt.load_backbone(args.backbone, arch, device=args.dev)
    else:
        print("WARNING: no --backbone weights; training against a random "
              "frozen backbone (smoke runs only).")
        backbone = init_resnet(arch, torch.Generator().manual_seed(0), device=args.dev)
    ch = {L: c for L, c in resnet_out_channels(arch).items() if L in cfg.refnet_layers}
    refiner = init_seg_network(ch, torch.Generator().manual_seed(1), use_bn=cfg.refnet_use_bn,
                               device=args.dev)

    ws = Path(args.workspace).expanduser().resolve()
    cache = TModelCache(ws / "tmodels_cache" / f"{arch}-c{cfg.disc.c_channels}")
    model = TrainerModel(cfg, backbone, refiner, cache, device=args.dev)

    # one stream of draws for sampling and batch order, as the JAX package's
    # global generators give it
    rng, py_rng = np.random.RandomState(), random.Random()
    datasets = []
    if args.dset in ("all", "dv2017"):
        datasets.append(lambda: DAVISTrainingDataset(args.dv2017, epoch_repeats=8,
                                                     sample_size=3, rng=rng, py_rng=py_rng))
    if args.dset in ("all", "yt2018"):
        datasets.append(lambda: YouTubeVOSTrainingDataset(args.yt2018, epoch_samples=4000,
                                                          min_seq_length=4, sample_size=3,
                                                          rng=rng, py_rng=py_rng))
    if args.dset == "synthetic":
        datasets.append(lambda: SyntheticTrainingDataset(n_samples=32, size=(120, 160)))

    trainer = Trainer(args.name, model, datasets, checkpoints_path=ws / "checkpoints",
                      log_path=ws / "logs", max_epochs=args.max_epochs,
                      batch_size=args.batch_size, rng=rng)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
