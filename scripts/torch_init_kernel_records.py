#!/usr/bin/env python3
"""The kernels of the fused tracker's disc_init on a 9-frame 480x854
sequence, read seven times in one process on the card (one, four, one, one,
one, four and one objects), each call in a torch.profiler session of CPU and
CUDA activity: the kernel records, the launch calls (cudaLaunchKernel,
cuLaunchKernel and their Ex forms) and the aten ops. chip_smoke.py's
`init_scaling` counts kernel records; where a pass reads fewer kernels than
launch calls with the same aten ops, the profiler lost records, and the code
took the same path.

    python3 scripts/torch_init_kernel_records.py
"""
import contextlib
import json
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.device import resolve_device
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    from frtm_tpu_torch.utils.profiling import PhaseTimer
    resolve_device("cuda")
    cs.phase_build()
    cfg = eval_config("resnet101")
    backbone, refiner = cs.build_models("resnet101", cfg, "cuda")
    plain = PhaseTimer.phase
    calls = []

    @contextlib.contextmanager
    def phase(self, name):
        if name != "disc_init":
            with plain(self, name):
                yield
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with plain(self, name):
                yield
            torch.cuda.synchronize()
        names = Counter(e.name for e in prof.events() if not cs.is_kernel(e))
        calls.append({"kernels": sum(1 for e in prof.events() if cs.is_kernel(e)),
                      "launch_calls": sum(names[k] for k in LAUNCH_CALLS),
                      "aten_ops": sum(v for k, v in names.items() if k.startswith("aten::")),
                      "aten_where": names["aten::where"],
                      "aten_convolution": names["aten::convolution"]})

    for n in (1, 4, 1, 1, 1, 4, 1):
        seq = make_moving_square_sequence(n_frames=9, size=(480, 854), square=120,
                                          n_objects=n, seed=0)
        fused = BatchedSequenceTracker(cfg, backbone, refiner, device="cuda", profile=True)
        fused.run_sequence(seq)
        fused.run_sequence(seq)
        PhaseTimer.phase = phase
        calls.clear()
        try:
            fused.run_sequence(seq)
        finally:
            PhaseTimer.phase = plain
        print(json.dumps({"objects": n, "disc_init_calls": calls}), flush=True)
        del fused
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
