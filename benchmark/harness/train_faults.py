"""Faults planted under a training cell's timed path, which its check
(harness/train.py::check_step) has to find. Each takes `patch(owner, name,
value)` (pytest's monkeypatch.setattr, or spans.Patches.set) and plants one
fault in the port's train step. On the card, each fault's readings:

    python3 benchmark/harness/train_faults.py --workload train.rn101 \\
        --fault amsgrad_raw_max --fault decay_dropped --seeds 1

(one process: each fault on --seeds seeds, with the window and readings of
control.py; each run prints its notes and a JSON line of its numbers and
`correct`, which has to be false).
"""
import argparse
import json
import sys
import time
from pathlib import Path


def amsgrad_raw_max(patch):
    """torch.optim.Adam(amsgrad=True)'s order: the maximum of the raw second
    moment, bias-corrected after, in place of optax's maximum of the
    bias-corrected second moments."""
    import torch
    from frtm_tpu_torch.runtime import trainer as tr

    @torch.no_grad()
    def step(self, lr):
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, mu, nu, nu_max in zip(self.params, self.mu, self.nu, self.nu_max):
            g = p.grad + self.weight_decay * p
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            torch.maximum(nu_max, nu, out=nu_max)
            p.add_((mu / bc1) / (torch.sqrt(nu_max / bc2) + self.eps) * -lr)
    patch(tr.AMSGrad, "step", step)


def decay_dropped(patch):
    """The L2 decay left out of the gradient the optimizer takes."""
    from frtm_tpu_torch.runtime import trainer as tr
    inner = tr.AMSGrad.step

    def step(self, lr):
        decay, self.weight_decay = self.weight_decay, 0.0
        try:
            return inner(self, lr)
        finally:
            self.weight_decay = decay
    patch(tr.AMSGrad, "step", step)


def bn_stats_frozen(patch):
    """Eval-mode BatchNorm in the train step: the decoder's BatchNorms
    normalise by their running statistics and leave them as they are."""
    from frtm_tpu_torch.ops import conv

    def frozen(x, weight, bias, running_mean, running_var, momentum=0.1, eps=1e-5, group=None):
        mean, var = running_mean.clone(), running_var.clone()
        return conv.batch_norm(x, weight, bias, mean, var, eps), (mean, var)
    patch(conv, "batch_norm_train", frozen)


def bwd_kernel_halved(patch):
    """One backward kernel's output scaled by 0.5: kernel 1's input
    gradient, which every gradient but the head's passes through."""
    import importlib
    pyrup = importlib.import_module("frtm_tpu_torch.ops.kernels.pyrup")
    inner = pyrup.pyr_up_bicubic_backward

    def halved(gy, in_shape):
        return 0.5 * inner(gy, in_shape)
    patch(pyrup, "pyr_up_bicubic_backward", halved)


FAULTS = {f.__name__: f for f in (amsgrad_raw_max, decay_dropped, bn_stats_frozen,
                                  bwd_kernel_halved)}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Each planted fault's readings on the card")
    ap.add_argument("--workload", default="train.rn101")
    ap.add_argument("--fault", action="append", choices=sorted(FAULTS), default=[])
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 307)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    repo = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(repo))
    import torch
    from benchmark.harness import core, spans
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    bench = core.load_bench()
    for k, fault in enumerate(f for f in args.fault for _ in range(args.seeds)):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        patches = spans.Patches()
        FAULTS[fault](patches.set)
        try:
            result = core.run_cell(bench, args.workload, seed, args.seconds, False, "cuda", t0,
                                   extra={"readings": True})
        finally:
            patches.restore()
        for line in result.pop("_notes"):
            print(line, flush=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "run": fault,
                          "correct": result["correct"],
                          "numbers": {n: v["value"] for n, v in result["limits"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
