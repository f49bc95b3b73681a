"""The readers of the port's label writer: `png_encode_ms_per_frame` and
`png_hidden_pct` on hand-made spans (the loop's `png_write` on the issuing
thread, `png_encode` on two writer threads, the window's sequences told from
the warm-up's by their requests), both silent on a port that writes its PNGs
on the loop's thread (no `png_encode` span) and on one without the recorder,
and both read from the tiny traced run on the CPU."""
import pytest

from benchmark.harness import core
from frtm_tpu_torch.utils import profiling
from frtm_tpu_torch.utils.profiling import Span

CELL = "davis17.rn101"
MAIN, WRITER_A, WRITER_B = 11, 22, 33         # thread ids
NEW = ("png_encode_ms_per_frame", "png_hidden_pct")
MS = 1_000_000


def sequence_spans(request, t, write_ms, encode_ms):
    """A sequence from time t: its run_sequence and png_write on the loop's
    thread, then its png_encode spans on the two writer threads (ms each)."""
    end = t + 1000 * MS
    out = [Span("run_sequence", t, end, 900 * MS, MAIN, -1, request),
           Span("png_write", end, end + write_ms * MS, write_ms * MS, MAIN, -1, request)]
    for thread, ms in zip((WRITER_A, WRITER_B), encode_ms):
        out.append(Span("png_encode", end, end + ms * MS, ms * MS // 2, thread, -1, request))
    return out


@pytest.fixture
def recorded(monkeypatch):
    """A warm-up sequence (w#0), then the window's two: 5 frames (a#1) and 9
    (b#2), 14 frames written. The window's png_write: 2 + 10 ms; png_encode:
    30 + 25 and 60 + 45 ms."""
    spans = (sequence_spans("w#0", 0, 500, (900, 800))
             + sequence_spans("a#1", 10_000 * MS, 2, (30, 25))
             + sequence_spans("b#2", 20_000 * MS, 10, (60, 45))
             + [Span("run_dataset", 0, 30_000 * MS, 0, MAIN, -1, None)])
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return {"records": [{"frames": 5, "objects": 1}, {"frames": 9, "objects": 2}]}


@pytest.mark.parametrize("name,want", [
    ("png_encode_ms_per_frame", (30 + 25 + 60 + 45) / 14),
    ("png_hidden_pct", 100 * (1 - (2 + 10) / (30 + 25 + 60 + 45)))])
def test_readers_take_the_windows_requests_on_every_thread(recorded, name, want):
    assert core.reader(name)(recorded) == pytest.approx(want)


def test_silent_where_the_loop_writes_its_own_pngs(monkeypatch, recorded):
    """The loop's thread writes every PNG inside `png_write`: no png_encode."""
    spans = [s for s in profiling.spans() if s.name != "png_encode"]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    for name in NEW:
        assert core.reader(name)(recorded) is None, name


def test_silent_without_a_span_of_every_window_sequence(recorded):
    recorded["records"] = recorded["records"] * 2
    for name in NEW:
        assert core.reader(name)(recorded) is None, name


def test_silent_on_a_port_without_the_recorder(monkeypatch, recorded):
    monkeypatch.delattr(profiling, "spans")
    for name in NEW:
        assert core.reader(name)(recorded) is None, name


def test_traced_run_reads_the_writer(tiny):
    """The tiny traced run on the CPU: the writer threads' encode time is
    read, and the loop's wait for them is part of it at most."""
    result = core.run_cell(core.load_bench(), CELL, 2**31 + 17, 0.2, True, "cpu", None, tiny)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["png_encode_ms_per_frame"] > 0
    assert got["png_hidden_pct"] <= 100
    assert got["png_write_ms_per_frame"] > 0
