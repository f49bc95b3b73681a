"""scripts/torch_train_eval_synthetic.py (the port of
scripts/train_eval_synthetic.py) on the CPU at a tiny size: it trains,
tracks held-out sequences in float32 and bfloat16, prints each sequence's J,
the mean J and the dtype IoU, then its JSON summary, and --min-j sets the
exit code; without --dev cpu it asks for the card, which this machine
lacks (about 25 s)."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch_train_eval_synthetic.py"
TINY = ["--epochs", "2", "--train-samples", "4", "--batch-size", "4", "--eval-seqs", "1",
        "--size", "64", "96", "--compare-dtypes"]


def run(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(SCRIPT), *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_script_trains_tracks_and_scores_on_the_cpu():
    """One run under an unreachable --min-j: everything printed, then the
    failure and exit code 1."""
    res = run("--dev", "cpu", *TINY, "--min-j", "1.01")
    assert res.returncode == 1, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert any(line.startswith("eval0: J=") for line in lines)
    assert any(line.startswith("mean J over 1 held-out sequences: ") for line in lines)
    assert any("f32-vs-bf16 mask IoU min over frames" in line for line in lines)
    assert lines[-1].startswith("FAIL: J")
    summary = json.loads(lines[-2])
    assert summary["device"] == "cpu" and len(summary["losses"]) == 2
    assert 0 <= summary["mean_j"] <= 1 and 0 <= summary["f32_vs_bf16_iou_min"] <= 1
    assert summary["min_j"] == 1.01


def test_script_asks_for_the_card():
    res = run(*TINY)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
