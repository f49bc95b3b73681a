"""The readings that the limits of `correct` are set from: a cell's short
window (one chunk of its walk, no warm-up) on each of several seeds, judged
by the reference as a run judges it. On the first seeds the port's numbers;
on the next `--control` seeds the control's, in the port's place (the
reference with float8 operands in its backbone's and decoder's convolutions
and a bfloat16 target model), whose run has to come out not correct; then
each `--fault` planted under the timed path (harness/faults.py) on
`--fault-seeds` seeds, which has to come out not correct too. One process,
on the card:

    python3 benchmark/control.py --workload davis17.rn101 --seeds 12 --control 3 \
        --fault insert_skipped --fault filters_discarded --fault-seeds 2 --chunk 3

Prints each run's notes and a JSON line of its numbers and `correct`; the
largest port reading and the smallest control reading go into PERF.md
beside the limit set between them (limits/<workload>.json).
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", type=int, default=2)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--chunk", type=int, default=0,
                    help="sequences a chunk of the walk (the mix's where 0): the window "
                         "runs one chunk, and the re-solve is captured in one of its first three")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    from benchmark.harness import core, spans
    from benchmark.harness.faults import FAULTS
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    bench = core.load_bench()
    runs = ([("port", None)] * args.seeds + [("control", None)] * args.control
            + [("fault", f) for f in args.fault for _ in range(args.fault_seeds)])
    for k, (kind, fault) in enumerate(runs):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        patches = spans.Patches()
        if fault is not None:
            FAULTS[fault](patches.set)
        try:
            result = core.run_cell(bench, args.workload, seed, args.seconds, False, "cuda", t0,
                                   overrides={"mix": {"chunk_sequences": args.chunk}}
                                   if args.chunk else None,
                                   extra={"control": kind == "control", "readings": True})
        finally:
            patches.restore()
        notes = result.pop("_notes")
        for line in notes:
            print(line, flush=True)
        numbers = {name: v["value"] for name, v in result["limits"].items()}
        port = numbers
        if kind == "control":
            words = next(n for n in notes if n.startswith("port ")).split()[1:]
            port = {words[i]: float(words[i + 1]) if words[i + 1] != "None" else None
                    for i in range(0, len(words), 2)}
        print(json.dumps({"workload": args.workload, "seed": seed, "run": fault or kind,
                          "correct": result["correct"], "numbers": numbers, "port": port,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
