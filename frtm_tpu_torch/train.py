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
there is none; `--dev cpu` must be asked for.

Data-parallel training, one process per card (runtime/trainer.py,
parallel/train_step.py), takes a global batch of --batch-size split by rows:
    python -m frtm_tpu_torch.train sess01 --dp 4 ...
        spawns 4 processes on this machine (rank r on cuda:r over NCCL, or
        on the CPU over gloo under --dev cpu), which meet through a file;
    torchrun --nproc-per-node 4 -m frtm_tpu_torch.train sess01 --multihost ...
        joins torchrun's world (NCCL on --dev cuda, gloo on --dev cpu); a
        --dp given beside it must equal the world's size.
Each process draws its own epoch samples, as each JAX process does; only
rank 0 writes checkpoints and statistics.
"""
import argparse
import os
import random
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


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
                    help="data-parallel over N devices, one process each (0 = one process)")
    ap.add_argument("--multihost", action="store_true",
                    help="join torchrun's world (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, "
                         "LOCAL_RANK) and train data-parallel over every process; each feeds "
                         "its own batch rows. One process where no world is declared.")
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


def _dp_worker(rank, argv, n, rendezvous, backend, device):
    """Rank `rank` of the `n` processes that `--dp n` spawns."""
    from .parallel.distributed import init_distributed
    os.environ["LOCAL_RANK"] = str(rank)        # its card, where it runs on one: cuda:rank
    init_distributed(f"file://{rendezvous}", n, rank, backend=backend, device=device)
    try:
        main(argv)
    finally:
        dist.destroy_process_group()


def _spawn(n, argv, backend, device):
    """--dp n where no world is declared: n processes on this machine, which
    meet through a file in a temporary directory; returns when all end and
    raises where one fails."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="frtm_dp_") as tmp:
        mp.start_processes(_dp_worker,
                           args=(argv, n, os.path.join(tmp, "rendezvous"), backend, device),
                           nprocs=n, join=True, start_method="spawn")


def main(argv=None):
    """Run the training; returns the Trainer, or None in a process that
    spawned the --dp processes."""
    ap = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.dev == "cuda" and not torch.cuda.is_available():
        sys.exit("--dev cuda: no CUDA device is available (torch.cuda.is_available() is "
                 "false); nothing runs on the CPU unless --dev cpu asks for it")
    if args.dp < 0:
        ap.error(f"--dp {args.dp}: the number of processes")
    if args.dp and args.batch_size % args.dp:
        ap.error(f"--batch-size {args.batch_size} must be divisible by --dp {args.dp}")
    backend = "nccl" if args.dev == "cuda" else "gloo"
    declared = dist.is_initialized() or bool(os.environ.get("WORLD_SIZE"))
    if args.dp and not declared:
        if args.dev == "cuda" and args.dp > torch.cuda.device_count():
            ap.error(f"--dp {args.dp}: this machine has {torch.cuda.device_count()} CUDA "
                     "device(s), one process each")
        _spawn(args.dp, argv, backend, args.dev)
        return None

    from .parallel.distributed import global_mesh, init_distributed
    pid, n_proc = 0, 1
    if args.multihost or args.dp:
        pid, n_proc = init_distributed(backend=backend, device=args.dev)
    if args.dp and args.dp != n_proc:
        ap.error(f"--dp {args.dp} in a world of {n_proc} processes: they must be equal")
    mesh = None
    if n_proc > 1 or args.dp:
        if args.batch_size % n_proc:
            ap.error(f"--batch-size {args.batch_size} must be divisible by the {n_proc} "
                     "processes")
        mesh = global_mesh(device=args.dev)
        print(f"multihost: process {pid}/{n_proc} on {mesh.device}")

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
                      batch_size=args.batch_size, rng=rng, mesh=mesh)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
