#!/usr/bin/env python3
"""Where the multi-sequence engine's labels part from the fused tracker's
on one sequence alone, on the card.

    python3 scripts/torch_sharded_agreement.py [--out results/sharded_agreement.json]

The rn101 eval configuration at 480x854 on chip_smoke.py's weights (seeded,
the head scaled as its `decode` phase scales it) and its `sharded` phase's
sequences (17 frames, two objects, seeds 0-3). For each type (bfloat16, the
CLI's, and float32) and group width B = 2 and 4, the largest share of a
frame's labels on which the group differs from the fused tracker on each
sequence alone; then, at B = 2, the pieces: the group's features against
the fused tracker's (bit-equal or not), its target models after the init
against those solved for each sequence alone (the largest difference over
the peak), and the group run again with each sequence's own init (its models
solved alone, the lanes joined): what is left is the decode's and the
loop's batch. The yardstick: the fused tracker's own label movement when
its init filters move by one part in 1e6.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def cat_lanes(trees):
    """Target models of several groups of lanes joined on the object axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    if isinstance(first, list):
        return [v for t in trees for v in t]
    if isinstance(first, dict):
        return {k: cat_lanes([t[k] for t in trees]) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{f.name: cat_lanes([getattr(t, f.name) for t in trees])
                                             for f in dataclasses.fields(first)})
    items = [cat_lanes(list(parts)) for parts in zip(*trees)]
    return type(first)(*items) if hasattr(first, "_fields") else tuple(items)


def gap(a, b):
    return max(float(np.mean(x != y)) for x, y in zip(a, b))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.parallel import ShardedSequenceTracker, make_mesh
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    from frtm_tpu_torch.runtime.tracker import Tracker
    resolve_device("cuda")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cfg = eval_config("resnet101")
    host = Tracker(cfg, *cs.build_models("resnet101", cfg, "cuda"), device="cuda")
    logits = cs.frame1_decoder(host, make_moving_square_sequence(
        n_frames=17, size=(480, 854), square=120, seed=0))()
    cs.scale_head(host.refiner, float(logits.median()), float(logits.std()))
    backbone, refiner = host.backbone, host.refiner
    seqs = cs.sharded_sequences(17)
    out = {"card": card, "types": {}}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        fused = BatchedSequenceTracker(c, backbone, refiner, extract_chunk=16, device="cuda")
        group = ShardedSequenceTracker(c, backbone, refiner, make_mesh(), extract_chunk=16,
                                       device="cuda")
        alone = {s.name: fused.run_sequence(s)[0] for s in seqs}
        r = {"label_gap": {}}
        for B in (2, 4):
            got = group.run_sequences(seqs[:B])
            r["label_gap"][B] = [gap(got[s.name], alone[s.name]) for s in seqs[:B]]

        # the pieces, at B = 2
        members = seqs[:2]
        key = group._group_key_meta(members[0])
        preps = [(s, group._prepare(s)) for s in members]
        feats = group._extract_group([p for _, p in preps], 16)
        equal = []
        for b, (s, p) in enumerate(preps):
            own = fused._extract_sequence(p["chunks"])
            equal.append(all(torch.equal(feats[L][b::2], own[L]) for L in own))
        r["features_bit_equal"] = equal

        inits, solo = [], group._init_objects
        for s, p in preps:
            f0 = [group._frame_dev(o[1], p["chunks"], p["frame0_dev"]) for o in p["objects"]]
            inits.append(solo(f0, [a for a, _ in p["aug_batches"]],
                              [b for _, b in p["aug_batches"]]))
        f0 = [group._frame_dev(o[1], p["chunks"], p["frame0_dev"])
              for _, p in preps for o in p["objects"]]
        batches = [a for _, p in preps for a in p["aug_batches"]]
        (params, _), _ = solo(f0, [a for a, _ in batches], [b for _, b in batches])
        joined = cat_lanes([m for m, _ in inits])
        r["init_filter_gap_over_peak"] = float(
            (params.filter - joined[0].filter).abs().max() / joined[0].filter.abs().max())

        def own_inits(f0, ims, lbs):
            return joined, torch.cat([m for _, m in inits])

        group._init_objects = own_inits
        got = group._run_group(preps, key)
        del group._init_objects
        r["label_gap_with_each_sequence_own_init"] = [gap(got[s.name], alone[s.name])
                                                      for s in members]

        # the yardstick: the fused tracker's filters after its init, moved by 1e-6
        init = fused._init_objects_dense

        def nudged(images, labels):
            models = init(images, labels)
            params, state = models
            return params._replace(filter=params.filter * (1 + 1e-6)), state

        fused._init_objects_dense = nudged
        r["yardstick_label_movement_under_1e-6_init_nudge"] = [
            gap(fused.run_sequence(s)[0], alone[s.name]) for s in members]
        del fused._init_objects_dense
        out["types"][dtype] = r
        print(json.dumps({dtype: r}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
