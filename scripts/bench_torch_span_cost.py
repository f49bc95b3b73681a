"""What the port's span recorder (frtm_tpu_torch/utils/profiling.py) costs
when it is on: traced runs of one benchmark cell and one seed, in pairs with
the recorder on (as the traced run has it: the tracker's profile=True turns
it on) and off (`profiling.recording` replaced by a no-op block), the order
alternating from pair to pair, each run a process of its own. Prints and
writes each run's traced fps and each side's median and quartiles
(statistics.quantiles), beside the card's name and power limit.

    python3 scripts/bench_torch_span_cost.py --workload davis17.rn101 --seed 7 \\
        --seconds 45 --pairs 3 --out span_cost.json

Needs a CUDA card, as benchmark/run.py does.
"""
import argparse
import contextlib
import json
import re
import statistics
import subprocess
import sys
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
STEPS = ("scan_prepare", "scan_forward", "scan_insert", "scan_resolve")


def child(mode: str, argv) -> int:
    """One traced run; with the recorder on, then as a JSON line on standard
    error the window's `scan` spans' thread-CPU time beside the sum of
    their four steps' (the window: what follows the warm-up's run_dataset),
    and the profiled sub-window's idle device time named by the innermost
    program span open on the issuing thread (harness/track.py's idle_gaps
    over the port's spans in place of the benchmark's wrappers)."""
    sys.path.insert(0, str(REPO))
    from frtm_tpu_torch.utils import profiling
    if mode == "off":
        profiling.recording = contextlib.nullcontext
    from benchmark import run
    from benchmark.harness import track
    context, inner = {}, track.run

    def keeping(**kwargs):
        out = inner(**kwargs)
        context.update(out.context)
        return out
    track.run = keeping
    rc = run.main(argv)
    spans = [s for s in profiling.spans() if s.end_ns is not None]
    if rc == 0 and mode == "on" and spans:
        warmup_end = next(s.end_ns for s in spans if s.name == "run_dataset")
        window = [s for s in spans if s.start_ns > warmup_end]
        scan = sum(s.cpu_ns for s in window if s.name == "scan")
        steps = sum(s.cpu_ns for s in window if s.name in STEPS)
        line = {"scan_cpu_ms": scan / 1e6, "scan_steps_cpu_ms": steps / 1e6}
        if "trace_window" in context:
            t0, t1 = context["trace_window"]
            busy, span_s, gaps = track.idle_gaps(
                context["device_intervals"], t0, t1,
                [(s.name, s.start_ns, s.end_ns, s.thread) for s in spans],
                threading.get_ident(), top=20)
            line.update(idle_s=span_s - busy, idle_by_program_span=gaps)
        print(json.dumps(line), file=sys.stderr)
    return rc


def one_run(mode, args):
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", mode, "--workload",
           args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds)]
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    if p.returncode != 0:
        raise SystemExit(f"{mode} run failed ({p.returncode}):\n{p.stderr[-3000:]}")
    result = json.loads(p.stdout.strip().splitlines()[-1])
    fps = float(re.search(r"traced fps ([0-9.e+-]+)", p.stderr).group(1))
    scan = [json.loads(line) for line in p.stderr.splitlines() if "scan_steps_cpu_ms" in line]
    return {"mode": mode, "traced_fps": fps, "correct": result["correct"],
            "spans": scan[-1] if scan else None,
            "metrics": {k: v["value"] for k, v in result["metrics"].items()}}


def summary(values):
    q = statistics.quantiles(values, n=4) if len(values) >= 2 else [values[0]] * 3
    return {"median": statistics.median(values), "q1": q[0], "q3": q[2], "runs": values}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="davis17.rn101")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", choices=("on", "off"))
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, ["--workload", args.workload, "--seed", str(args.seed),
                                  "--seconds", str(args.seconds), "--trace", "1"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs = []
    for i in range(args.pairs):
        for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
            runs.append(one_run(mode, args))
            print(json.dumps(runs[-1]), flush=True)
    out = {"card": card.strip(), "workload": args.workload, "seed": args.seed,
           "seconds": args.seconds, "runs": runs,
           "traced_fps": {m: summary([r["traced_fps"] for r in runs if r["mode"] == m])
                          for m in ("on", "off")}}
    on, off = out["traced_fps"]["on"]["median"], out["traced_fps"]["off"]["median"]
    out["on_cost_pct"] = 100.0 * (off - on) / off
    print(json.dumps({k: out[k] for k in ("card", "traced_fps", "on_cost_pct")}))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
