"""The span recorder of utils/profiling.py on the CPU: off, it records
nothing and hands out one shared no-op; on, its spans nest by thread, keep
their thread-CPU time and request, and share torch.profiler's clock;
a request read on one thread is served by spans on another;
PhaseTimer's phases become spans without their stats moving; trace()
writes the spans beside the profiler's events."""
import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from frtm_tpu_torch.utils import profiling
from frtm_tpu_torch.utils.profiling import PhaseTimer


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    yield
    profiling.reset()


def _burn(seconds):
    """Spend `seconds` of this thread's CPU time."""
    end = time.thread_time() + seconds
    while time.thread_time() < end:
        pass


def test_off_records_nothing_and_shares_one_no_op():
    first = profiling.span("a")
    assert profiling.span("b") is first and profiling.request("r") is first
    with profiling.span("a"), profiling.request("r"):
        profiling.count("n", 3)
    assert profiling.spans() == [] and profiling.counts() == {}


def test_spans_nest_with_parent_indices_and_thread_cpu():
    with profiling.recording():
        with profiling.span("outer"):
            with profiling.span("inner"):
                _burn(0.01)
            with profiling.span("second"):
                time.sleep(0.02)
        with profiling.span("root"):
            pass
    got = profiling.spans()
    assert [s.name for s in got] == ["outer", "inner", "second", "root"]
    assert [s.parent for s in got] == [-1, 0, 0, -1]
    for s in got:
        assert s.thread == threading.get_ident() and s.request is None
        assert s.start_ns <= s.end_ns and 0 <= s.cpu_ns <= s.end_ns - s.start_ns
    outer, inner, second, _ = got
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= second.start_ns <= outer.end_ns
    # a busy loop spends its thread's CPU, a sleep hardly any
    assert inner.cpu_ns >= 10_000_000 and second.cpu_ns < 5_000_000
    assert second.end_ns - second.start_ns >= 20_000_000
    # the block closed: nothing more is recorded
    with profiling.span("late"):
        pass
    assert len(profiling.spans()) == 4


def test_each_thread_keeps_its_own_stack():
    started, release = threading.Barrier(2), threading.Barrier(2)

    def work(tag):
        with profiling.span(f"{tag}.outer"):
            started.wait(timeout=10)
            with profiling.span(f"{tag}.inner"):
                release.wait(timeout=10)

    with profiling.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    got = profiling.spans()
    assert len(got) == 4
    for tag in "ab":
        outer = next(i for i, s in enumerate(got) if s.name == f"{tag}.outer")
        inner = next(s for s in got if s.name == f"{tag}.inner")
        assert inner.parent == outer and inner.thread == got[outer].thread
    assert len({s.thread for s in got}) == 2


def test_threads_lose_no_span_or_count():
    """More threads than cores record spans and counts at once, switching
    every microsecond: none is lost and every parent is its own thread's."""
    import os
    import sys
    n_threads, n_spans = (os.cpu_count() or 1) + 4, 200
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with profiling.request("r"):
                for _ in range(n_spans):
                    with profiling.span("outer"), profiling.span("inner"):
                        profiling.count("n")

        with profiling.recording():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    got = profiling.spans()
    assert len(got) == 2 * n_threads * n_spans
    assert profiling.counts() == {"n": n_threads * n_spans}
    for s in got:
        if s.name == "inner":
            assert got[s.parent].name == "outer" and got[s.parent].thread == s.thread
            assert got[s.parent].request == s.request
    assert len({s.request for s in got}) == n_threads


def test_requests_counters_and_reset():
    with profiling.recording():
        with profiling.request("seq"):
            with profiling.request("ignored"), profiling.span("a"):
                profiling.count("resolves")
                profiling.count("resolves", 2)
        with profiling.request("seq"), profiling.span("b"):
            profiling.count("resolves")
        profiling.count("outside", 5)
    a, b = profiling.spans()
    assert a.request.startswith("seq#") and b.request.startswith("seq#")
    assert a.request != b.request
    assert profiling.counts() == {"resolves": 4, "outside": 5}
    assert profiling.counts({a.request}) == {"resolves": 3}
    assert profiling.counts({b.request, None}) == {"resolves": 1, "outside": 5}
    profiling.reset()
    assert profiling.spans() == [] and profiling.counts() == {}


def test_a_request_is_carried_to_another_thread():
    """current_request() read on one thread and given to span(name,
    request=...) on another: that span and the spans inside it serve the
    request there, and the other thread is outside it before and after."""
    seen = {}

    def work(request):
        seen["before"] = profiling.current_request()
        with profiling.span("encode", request=request):
            seen["inside"] = profiling.current_request()
            with profiling.span("file"):
                pass
        seen["after"] = profiling.current_request()
        with profiling.span("later"):
            pass

    assert profiling.current_request() is None
    with profiling.recording():
        with profiling.request("seq"):
            request = profiling.current_request()
            with profiling.span("hand_off"):
                t = threading.Thread(target=work, args=(request,))
                t.start()
                t.join(timeout=10)
        assert not t.is_alive() and profiling.current_request() is None
    got = {s.name: s for s in profiling.spans()}
    assert request.startswith("seq#")
    assert seen == {"before": None, "inside": request, "after": None}
    assert got["encode"].request == got["file"].request == got["hand_off"].request == request
    assert got["later"].request is None
    assert got["file"].parent == list(got).index("encode")
    assert got["encode"].thread == got["file"].thread != got["hand_off"].thread
    # off, a span with a request is the shared no-op and sets nothing
    assert profiling.span("x", request=request) is profiling.span("y")
    with profiling.span("x", request=request):
        assert profiling.current_request() is None


def test_phase_timer_records_its_phases_as_spans():
    def timed(timer):
        with timer.phase("augment"):
            _burn(0.005)
        with timer.phase("scan"):
            with profiling.span("scan_forward"):
                _burn(0.005)
        with timer.phase("scan"):
            pass

    plain, recorded = PhaseTimer(sync=True, device="cpu"), PhaseTimer(sync=True, device="cpu")
    timed(plain)
    assert profiling.spans() == []
    with profiling.recording():
        timed(recorded)
    names = [s.name for s in profiling.spans()]
    assert names == ["augment", "scan", "scan_forward", "scan"]
    assert profiling.spans()[2].parent == 1
    a, b = plain.stats(), recorded.stats()
    assert a.keys() == b.keys() == {"augment", "scan"}
    for k in a:
        assert a[k].keys() == b[k].keys() and a[k]["count"] == b[k]["count"]
    for s in profiling.spans():
        assert s.cpu_ns <= s.end_ns - s.start_ns


def test_spans_share_the_profilers_clock():
    """torch.profiler stamps its events in time.time_ns(): an aten op run
    inside a span lies between the span's start and end."""
    a = torch.ones(128, 128)
    with profiling.recording(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("matmul"):
            a.mm(a)
    sp, = profiling.spans()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert sp.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= sp.end_ns


def test_trace_writes_the_spans_around_the_profilers_events(tmp_path):
    a = torch.ones(128, 128)
    with profiling.trace(tmp_path):
        with profiling.span("outer"):
            with profiling.span("matmul"):
                a.mm(a)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"outer", "matmul"}
    mm = next(e for e in events if e.get("name") == "aten::mm")
    for name in ("outer", "matmul"):
        sp = spans[name]
        assert sp["ph"] == "X" and sp["tid"] == threading.get_ident()
        assert sp["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"]
    assert any(e.get("ph") == "M" and e.get("tid") == threading.get_ident() for e in events)
    # the recorder was on for the block alone
    assert profiling.span("x") is profiling.span("y")
