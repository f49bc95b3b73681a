"""The harness end to end on a tiny cell on the CPU (the port's kernels in
their plain versions): the result line's keys, the per-layer readers, the
check passing on the sound port, failing on each fault planted under the
timed path (harness/faults.py) and on the control in the port's place."""
import io
import json

import numpy as np
import pytest

from benchmark.harness import core
from benchmark.harness.faults import FAULTS

CELL = "davis17.rn101"


def run(tiny, trace=False, seed=5, **extra):
    return core.run_cell(core.load_bench(), CELL, seed, 0.2, trace, "cpu", None, tiny,
                         extra=extra or None)


def test_result_line_and_check(tiny):
    result = run(tiny)
    assert result["correct"] is True
    # float32 on both sides: the fused tracker and the host loop's order
    assert all(v["value"] < 1e-3 for v in result["limits"].values())
    assert set(result["metrics"]) == {"fps", "setup_s"}
    assert result["attempted"] >= 2 and result["failed"] == 0
    out, err = io.StringIO(), io.StringIO()
    core.emit(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "limits"
    tail = err.getvalue().strip().splitlines()[-len(result["limits"]):]
    assert [t.split()[:2] for t in tail] == [["check", k] for k in line["limits"]]


def test_traced_run_reads_the_phase_metrics(tiny):
    result = run(tiny, trace=True)
    got = result["metrics"]
    for name in ("seq_fps_mean", "seq_s_p90", "scan_ms_per_frame", "scan_host_ms_per_frame",
                 "augment_ms_per_object", "extract_ms_per_frame", "disc_init_ms_per_object",
                 "mfu.track"):
        assert got[name]["value"] > 0, name
    # no card: no kernel timed, no device trace; those readers stay silent
    for name in ("kernels_roofline.track", "pyrup_roofline", "device_idle_pct.track"):
        assert name not in got
    assert "fps" not in got


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(tiny, monkeypatch, fault):
    """Each fault moves a number that the check compares. The tiny cell runs
    float32, where the sound port reads every number under 1e-3 (above), so
    it is judged against 1e-3; the cell's own limits are held against the
    faults at the cell's size on the card (PERF.md), where the refiner's
    masks follow the target model's scores more than a tiny random one's."""
    FAULTS[fault](monkeypatch.setattr)
    tight = {k: 1e-3 for k in core.load_limits(CELL)}
    result = run(dict(tiny, limits=tight))
    assert result["correct"] is False, result["limits"]


def test_the_control_in_the_ports_place_is_not_correct(tiny):
    """The control (float8 backbone and decoder, bfloat16 target model and
    re-solve) in the port's place on the tiny cell: its numbers are the ones
    compared, none reads below the port's, which matches the reference to
    its last pixels in float32, and one breaks its limit (the card's readings, at the cell's own
    sizes, are in PERF.md)."""
    result = run(tiny, control=True)
    assert result["correct"] is False, result["limits"]
    words = next(n for n in result["_notes"] if n.startswith("port ")).split()[1:]
    port = {words[i]: float(words[i + 1]) for i in range(0, len(words), 2)}
    for name, v in result["limits"].items():
        assert port[name] < 1e-3, name
        assert v["value"] >= port[name], name
    assert any(v["value"] > v["limit"] for v in result["limits"].values())


def test_sample_takes_the_longest_and_the_captured_or_one_drawn_from_the_seed():
    from benchmark.harness.check import sample
    recs = [{"frames": f} for f in (40, 104, 60, 104, 34)]
    picks = [sample(recs, s) for s in range(20)]
    assert all(p[0] == 1 and len(p) == 2 and p[1] != 1 for p in picks)
    assert len({p[1] for p in picks}) > 1
    assert sample(recs, 7) == sample(recs, 7)
    assert sample(recs, 7, also=2) == [1, 2]
    assert sample(recs, 7, also=1) == sample(recs, 7)
    assert np.array_equal(sample(recs[:1], 3), [0])
