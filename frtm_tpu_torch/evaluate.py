"""Evaluate the tracker on a VOS validation dataset: the port's counterpart of
the JAX package's evaluate.py, with its command-line surface.

    python -m frtm_tpu_torch.evaluate --model rn101_all.pth --dset dv2017val \\
        --davis /data/DAVIS --backbone resnet101.pth --output /data/results

It loads a reference-format refiner .pth (the backbone is autodetected from
it) or a frtm_tpu `.npz` model (its arch is stored in it), builds the eval configuration, tracks every sequence of the dataset,
writes indexed PNGs under <output>/<dataset>-<model>[_fast]/<sequence>/ and
scores J and F into evaluation-J.txt and evaluation-F.txt beside them.

It runs on the card (`--dev cuda`, the default) and exits with an error where
there is none; `--dev cpu` must be asked for. `--dtype` defaults to bfloat16,
`--engine` to the fused tracker. `--engine sharded` tracks groups of
sequences in one pass each (parallel/multi_sequence.py). `--multihost` joins
the processes that torchrun (or MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK set by hand) starts, one per card: each tracks its round-robin
share of the sequences, and rank 0 scores after a barrier. `--spatial` is
parsed and refused: height sharding is not ported yet.
"""
import argparse
import sys
import zipfile
from pathlib import Path

import torch

NOT_PORTED = ("{what} is not ported to frtm_tpu_torch yet: height sharding is "
              "ROADMAP.md queue item 7")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m frtm_tpu_torch.evaluate",
                                 description="Evaluate FRTM (PyTorch / CUDA port) on a "
                                             "validation dataset")
    ap.add_argument("--model", type=str, required=True,
                    help="refiner weights: a reference-format .pth")
    ap.add_argument("--dset", type=str, required=True,
                    choices=["dv2016val", "dv2017val", "yt2018jjval", "yt2018val"])
    ap.add_argument("--dev", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="device to run on; cuda needs a card, there is no fallback")
    ap.add_argument("--fast", action="store_true",
                    help="use the reduced optimizer schedule (FRTM-fast)")
    ap.add_argument("--davis", type=str, default="/data/DAVIS", help="DAVIS root")
    ap.add_argument("--yt2018", type=str, default="/data/ytvos2018",
                    help="YouTubeVOS 2018 root")
    ap.add_argument("--output", type=str, default="results", help="output root")
    ap.add_argument("--backbone", type=str, default=None,
                    help="torchvision-format resnet .pth (backbones are not "
                         "part of FRTM checkpoints)")
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=["float32", "bfloat16"], help="backbone/refiner compute dtype")
    ap.add_argument("--restart", type=str, default=None,
                    help="sequence name to restart from (debugging)")
    ap.add_argument("--engine", type=str, default="fused",
                    choices=["fused", "host", "sharded"],
                    help="fused = whole-sequence extract and windowed decode; host = "
                         "frame-at-a-time reference-semantics loop; sharded = groups of "
                         "sequences tracked in one pass each")
    ap.add_argument("--spatial", type=int, default=0,
                    help="fused engine: shard each frame's height over N devices "
                         "(not ported yet)")
    ap.add_argument("--multihost", action="store_true",
                    help="partition the dataset's sequences across the processes of "
                         "a torchrun launch (one per card); rank 0 scores")
    ap.add_argument("--pipeline", action="store_true",
                    help="fused engine: prepare the next sequence (decode, uploads, "
                         "augmentation) during the current one's tracking (faster "
                         "dataset wall; per-sequence fps then excludes augment and "
                         "is not protocol-comparable)")
    ap.add_argument("--aug-compact", choices=("auto", "on", "off"), default="auto",
                    help="fused engine: take augment batches in the compact "
                         "device-composed encoding. auto = off (the JAX package "
                         "turns it on only where its backend is a TPU)")
    return ap


def open_dataset(args):
    from .data.datasets import DAVISDataset, YouTubeVOSDataset
    if args.dset in ("dv2016val", "dv2017val"):
        return DAVISDataset(path=args.davis, year=args.dset[2:6], split="val")
    split = {"yt2018jjval": "jjval_all_frames", "yt2018val": "valid_all_frames"}[args.dset]
    return YouTubeVOSDataset(path=args.yt2018, year="2018", split=split)


def load_models(args):
    """What both CLIs load: (model path, arch, refiner, backbone) on
    args.dev, the backbone seeded at random where --backbone is not given.
    Exits with an error where --dev cuda finds no card, or the model file is
    missing or neither a reference-format .pth nor a frtm_tpu .npz model."""
    if args.dev == "cuda" and not torch.cuda.is_available():
        sys.exit("--dev cuda: no CUDA device is available (torch.cuda.is_available() is "
                 "false); nothing runs on the CPU unless --dev cpu asks for it")
    from .utils import checkpoints as ckpt
    from .utils.convert import init_resnet

    model_path = Path(args.model)
    if not model_path.exists():
        sys.exit(f"Model file '{model_path}' not found.")
    if model_path.suffix == ".pth":
        arch, refiner = ckpt.load_reference_model(model_path, device=args.dev)
    else:
        # the JAX package's own model format, as its CLIs read it
        try:
            arch, refiner = ckpt.load_jax_model(model_path, device=args.dev)
        except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
            sys.exit(f"{model_path.name}: not a reference-format .pth nor a frtm_tpu .npz "
                     f"model ({e})")
    if args.backbone:
        backbone = ckpt.load_backbone(args.backbone, arch, device=args.dev)
    else:
        print("WARNING: no --backbone weights given; using random backbone "
              "(benchmark-only; J&F will be meaningless).")
        backbone = init_resnet(arch, torch.Generator().manual_seed(0), device=args.dev)
    return model_path, arch, refiner, backbone


def main(argv=None, dataset=None):
    """Run the evaluation. `dataset`: a dataset object to track and score in
    place of the one `--dset` names on disk (the flag still names the
    protocol: dv2016val runs with a warm-up pass). Returns the results
    directory, the fps (the average per sequence; the sharded engine's
    aggregate), the J and F dataset means (None on ranks other than 0) and
    the tracker."""
    args = build_parser().parse_args(argv)
    if args.spatial:
        sys.exit(NOT_PORTED.format(what="--spatial"))
    model_path, arch, refiner, backbone = load_models(args)

    from .config import eval_config
    from .eval.evaluation import evaluate_dataset
    from .runtime.sequence_tracker import BatchedSequenceTracker
    from .runtime.tracker import Tracker

    cfg = eval_config(arch, fast=args.fast, compute_dtype=args.dtype)
    dset = open_dataset(args) if dataset is None else dataset
    ex_name = dset.name + "-" + model_path.stem + ("_fast" if args.fast else "")
    out_path = Path(args.output).expanduser().resolve() / ex_name
    out_path.mkdir(exist_ok=True, parents=True)

    pid, n_proc, dset_run = 0, 1, dset
    if args.multihost:
        from .parallel.distributed import init_distributed, process_slice
        pid, n_proc = init_distributed(device=args.dev)
        if n_proc > 1:
            # sequences are independent: each process tracks its round-robin
            # share and writes into the shared out_path
            seqs = list(dset)
            keep = set(process_slice(len(seqs), pid, n_proc))

            class Share(list):
                """This process's share, with the dataset's name."""
                name = dset.name

            dset_run = Share(s for i, s in enumerate(seqs) if i in keep)
            print(f"multihost: process {pid}/{n_proc} tracking "
                  f"{len(dset_run)}/{len(seqs)} sequences")

    speedrun = args.dset == "dv2016val"
    if args.engine == "host":
        if args.pipeline:
            print("WARNING: --pipeline applies to the fused and sharded engines only; "
                  "ignored for --engine host.")
        tracker = Tracker(cfg, backbone, refiner, device=args.dev)
        fps = tracker.run_dataset(dset_run, out_path, speedrun=speedrun, restart=args.restart)
    elif args.engine == "sharded":
        from .parallel import ShardedSequenceTracker, local_mesh, make_mesh
        # in a run of several processes each tracks its share on its own card
        mesh = local_mesh(args.dev) if n_proc > 1 else make_mesh(device=args.dev)
        tracker = ShardedSequenceTracker(cfg, backbone, refiner, mesh, extract_chunk=16,
                                         device=args.dev)
        fps = tracker.run_dataset(dset_run, out_path, speedrun=speedrun, restart=args.restart,
                                  pipeline=args.pipeline)
    else:
        tracker = BatchedSequenceTracker(cfg, backbone, refiner, extract_chunk=16,
                                         aug_compact=args.aug_compact == "on",
                                         device=args.dev)
        fps = tracker.run_dataset(dset_run, out_path, speedrun=speedrun, restart=args.restart,
                                  pipeline=args.pipeline)

    if n_proc > 1:
        # every process has written its PNGs before rank 0 scores
        from .parallel.distributed import barrier
        barrier("frtm_eval_outputs_done")
        if pid != 0:
            return {"out_path": out_path, "fps": fps, "J": None, "F": None, "tracker": tracker}

    dset.all_annotations = True
    print("\nComputing J-scores")
    j = evaluate_dataset(dset, out_path, measure="J")
    print("\nComputing F-scores")
    f = evaluate_dataset(dset, out_path, measure="F")
    return {"out_path": out_path, "fps": fps, "J": j, "F": f, "tracker": tracker}


if __name__ == "__main__":
    main()
