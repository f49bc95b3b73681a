#!/usr/bin/env python3
"""The kernels one device-augmenter round runs, counted by torch.profiler in
six sessions at 4 and at 19 specs, in a fresh process on the card: the
per-session counts and, per session, the kernel names whose count differs
from the first session's. Run after a large allocation and after
`torch.cuda.empty_cache()` too. chip_smoke.py's `device_augment` compares
the two widths' counts late in its run, where torch.profiler has been seen
to lose events.

    python3 scripts/torch_augment_round_kernels.py
"""
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.models import device_augmenter as tda
    resolve_device("cuda")
    aug_params = eval_config("resnet101").aug_params
    frame = cs.textured_frame((480, 854), seed=4)
    mask = np.zeros((480, 854, 1), np.float32)
    mask[150:270, 300:420] = 1

    def report(tag):
        for n in (5, 20):
            p = dict(aug_params, fg_aug_params=dict(aug_params["fg_aug_params"], num_aug=n),
                     bg_aug_params=dict(aug_params["bg_aug_params"], num_aug=n))
            aug = tda.DeviceAugmenter(p, "cuda")
            aug.augment_first_frame(frame, mask, np.random.RandomState(0))
            sessions = []
            for _ in range(6):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    aug.augment_first_frame(frame, mask, np.random.RandomState(0))
                    torch.cuda.synchronize()
                sessions.append(Counter(ev.name for ev in prof.events() if cs.is_kernel(ev)))
            first = sessions[0]
            print(json.dumps({"when": tag, "specs": n - 1,
                              "kernels_per_session": [sum(c.values()) for c in sessions],
                              "differing_names": [{k: c[k] - first[k] for k in set(c) | set(first)
                                                   if c[k] != first[k]} for c in sessions[1:]]}),
                  flush=True)

    report("fresh")
    big = [torch.empty(int(2e9), dtype=torch.uint8, device="cuda") for _ in range(6)]
    del big
    report("after_12_GB_allocated_and_freed")
    torch.cuda.empty_cache()
    report("after_empty_cache")


if __name__ == "__main__":
    main()
