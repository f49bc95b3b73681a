#!/usr/bin/env python3
"""The fused tracker's two first-frame augment backends, "host" against
"device", in one process on one CUDA card: the port's counterpart of
scripts/bench_augment_backend.py.

    python3 scripts/bench_torch_augment_backend.py [--frames N] [--passes P]
        [--out FILE]

The rn101 eval configuration in bfloat16 (as the CLI runs it) with the
seeded random weights of chip_smoke.py (build_models, the head scaled from
frame 1's logits as its main phase does), on synthetic 480x854 sequences of
N frames (default 9) with one and with two 120 px squares. Per number of
objects and backend (chip_smoke.augment_backend_readings): the fps of P
unsynchronised passes after a warm-up (augment inside the clock, as the
reference protocol has it), the augment and disc_init seconds of a pass
synchronised at every phase edge, and, for one augment_first_frame of
object 1, the kernels it ran, the port's kernel launches and the peak memory
it allocated. Also the share of labels the two backends agree on. Prints one
JSON line per number of objects, the card's name and power limit first, and
writes them all to FILE (default build/augment_backend.json).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "augment_backend.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from dataclasses import replace
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.runtime.tracker import Tracker

    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    lines = [{"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}]
    print(json.dumps(lines[0]), flush=True)
    cfg = eval_config("resnet101")
    tracker = Tracker(cfg, *cs.build_models("resnet101", cfg, "cuda"), device="cuda")
    seq = make_moving_square_sequence(n_frames=17, size=(480, 854), square=120, seed=0)
    logits = cs.frame1_decoder(tracker, seq)()
    cs.scale_head(tracker.refiner, float(logits.median()), float(logits.std()))
    bf16 = replace(cfg, compute_dtype="bfloat16")
    for n in (1, 2):
        readings, labels = cs.augment_backend_readings(bf16, tracker.backbone, tracker.refiner,
                                                       n_objects=n, n_frames=args.frames,
                                                       passes=args.passes)
        line = {"objects": n, "frames": args.frames, "size": [480, 854], "dtype": "bfloat16",
                "card": card, "backends": readings,
                "label_agreement_device_vs_host": [
                    float(np.mean(a == b)) for a, b in zip(labels["device"], labels["host"])],
                "fps_device_over_host": readings["device"]["fps_median"]
                / readings["host"]["fps_median"]}
        lines.append(line)
        print(json.dumps(line), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
