"""BENCHMARK.json against the contract's characters and the files the
harness finds by name."""
import json
import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert ONE_LINE.match(text), text
    assert 1 <= BENCH["run_seconds"] <= 51


def test_files_found_by_name():
    bench_dir = REPO / "benchmark"
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert (bench_dir / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench_dir / "limits" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1
    for m in BENCH["per_layer"]:
        assert (bench_dir / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for p in bench_dir.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(REPO))), p
