#!/usr/bin/env python3
"""The fused tracker's disc_init and scan at 1, 2 and 4 objects on one CUDA
card, for this tree and, with --parent, for another one.

    python3 scripts/bench_torch_init_scaling.py                  # this tree
    python3 scripts/bench_torch_init_scaling.py --parent DIR     # and DIR's
    python3 scripts/bench_torch_init_scaling.py --out FILE       # where to write

DIR is the root of another checkout of the repository (for example a `git
archive` of the parent commit, unpacked into a directory that git ignores);
its frtm_tpu_torch is imported in place of this tree's. Each run is a
process of its own; with --parent they go in the order parent, this, this,
parent, so that a drift of the card's clocks shows as a gap between the two
runs of one tree.

A run builds the rn101 eval configuration with the seeded random weights of
chip_smoke.py (build_models, and the head scaled from frame 1's logits as its
main phase does) and takes chip_smoke.init_scaling_readings: per number of
objects, a 9-frame 480x854 sequence, all objects from frame 0, through
BatchedSequenceTracker.run_sequence; the disc_init and scan seconds of a pass
synchronised at every phase edge, and, from another such pass, the kernels
each phase ran (a torch.profiler session per phase) and the peak memory
allocated inside it. Prints one JSON line per run, the card's name and power
limit first, and writes them all to FILE (default build/init_scaling.json).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tree(tree: Path, label: str):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                   # this tree's, whatever the tree
    sys.path.insert(0, str(tree))             # the tree's frtm_tpu_torch before this one's
    import torch
    import frtm_tpu_torch
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.runtime.tracker import Tracker
    if not Path(frtm_tpu_torch.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"imported {frtm_tpu_torch.__file__}, not the package of {tree}")
    resolve_device("cuda")
    cfg = eval_config("resnet101")
    tracker = Tracker(cfg, *cs.build_models("resnet101", cfg, "cuda"), device="cuda")
    seq = make_moving_square_sequence(n_frames=17, size=(480, 854), square=120, seed=0)
    logits = cs.frame1_decoder(tracker, seq)()
    cs.scale_head(tracker.refiner, float(logits.median()), float(logits.std()))
    readings = cs.init_scaling_readings(cfg, tracker.backbone, tracker.refiner)
    print(json.dumps({"tree": label, "path": str(tree), "torch": torch.__version__,
                      "objects": readings}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of another checkout")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "init_scaling.json")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:
        run_tree(args.tree, args.label)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    order = [("this", ROOT)]
    if args.parent is not None:
        order = [("parent", args.parent), ("this", ROOT), ("this", ROOT),
                 ("parent", args.parent)]
    lines = [{"card": card}]
    for label, tree in order:
        out = subprocess.run([sys.executable, __file__, "--tree", str(tree), "--label", label],
                             capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            raise SystemExit(f"{label} run failed ({out.returncode})")
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        lines.append(line)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
