"""The harness's general part: it finds a cell's configuration, traffic mix
and metric readers by the names in BENCHMARK.json, hands the cell to the
driver its mix names (harness/<driver>.py), and prints the result line.

A cell is run by `run_cell`; the driver returns a `CellRun`, whose
`context` the per-layer readers (metrics/<name>.py, each with
`read(context) -> float | None`) take their numbers from. A reader that
finds nothing returns None and its metric is left out of the line.
"""
import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "frtm_tpu")


@dataclass
class CellRun:
    """What a driver hands back: the end-to-end values it took itself
    ({name: value}), the reader context, the device block, the numbers
    compared for `correct` ({name: (value, limit)}), and the counts."""
    end_to_end: dict
    context: dict
    device: dict
    checks: dict
    attempted: int
    failed: int
    breakdown: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return all(v is not None and v <= lim for v, lim in self.checks.values())


def load_bench(path=None) -> dict:
    return json.loads(Path(path or REPO / "BENCHMARK.json").read_text())


def cell_of(bench: dict, workload: str):
    """(workload entry, configuration entry, configuration file's dict,
    mix dict) of a cell."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((REPO / conf["file"]).read_text())
    from .traffic import load_mix
    mix = load_mix(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    return w, conf, config, mix


def load_limits(workload: str) -> dict:
    """limits/<workload>.json: {number compared: its limit}."""
    return json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of this cell reports: the end-to-end ones
    without tracing, the per-layer ones with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start=None, overrides=None, extra=None) -> dict:
    """Run one cell once; returns the result object (without printing it).
    The limits of its compared numbers are limits/<workload>.json.
    overrides: {"config": {...}, "mix": {...}} entries laid over the files'
    (a test's small sizes), and "limits" in place of the file's; extra:
    further keyword arguments of the driver (control.py's `control=True`)."""
    w, conf, config, mix = cell_of(bench, workload)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    mix = {**mix, **overrides.get("mix", {})}
    limits = overrides.get("limits") or load_limits(workload)
    driver = importlib.import_module(f"{__package__}.{mix['driver']}")
    run = driver.run(config=config, mix=mix, limits=limits, seed=seed, seconds=seconds,
                     trace=trace, device=device, t_start=t_start, **(extra or {}))
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = (run.end_to_end.get(m["name"]) if not trace
                 else reader(m["name"])(run.context))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": run.device}
    if trace and run.breakdown:
        result["breakdown"] = run.breakdown
    result["limits"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    result["_notes"] = run.notes
    return result


def emit(result: dict, out=None, err=None) -> None:
    """Notes, then each compared number beside its limit as the last lines
    of standard error; the result as the last line of standard output, its
    `limits` key last."""
    out, err = out or sys.stdout, err or sys.stderr
    for line in result.pop("_notes", []):
        print(line, file=err)
    for k, v in result["limits"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err)
    err.flush()
    limits = result.pop("limits")
    result["limits"] = limits
    print(json.dumps(result), file=out)
    out.flush()
