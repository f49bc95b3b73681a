"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload davis17.rn101 --seed 7 --seconds 45 --trace 0

from the root of a checkout. It needs as many CUDA cards as the cell asks
for and exits non-zero without them, printing no result. The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, with --trace 1 breakdown, and last the numbers compared for
`correct` beside their limits); standard error ends with those numbers.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    from benchmark.harness import core

    # one process, few threads: the card's work is issued by one thread, and
    # no CPU thread pool competes with it
    torch.set_num_threads(2)

    bench = core.load_bench()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = core.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    core.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
