"""The readers of the port's own spans and counters: each on hand-made spans
(the window's sequences told from the warm-up's by their requests), the
unnamed share of the idle time on a hand-made timeline, every reader silent
on a port without the recorder, and the tiny traced run on the CPU reading
the eight that need no card."""
import pytest

from benchmark.harness import core
from frtm_tpu_torch.utils import profiling
from frtm_tpu_torch.utils.profiling import Span

CELL = "davis17.rn101"
MAIN, OTHER = 11, 22          # thread ids
NEW = ("png_write_ms_per_frame", "label_download_ms_per_frame",
       "scan_prepare_host_ms_per_frame", "scan_forward_host_ms_per_frame",
       "scan_insert_host_ms_per_frame", "scan_resolve_host_ms_per_frame",
       "resolves_per_frame", "disc_init_host_ms_per_object", "device_idle_unspanned_pct.track")
MS = 1_000_000


def sequence_spans(request, t, scale):
    """A sequence's spans from time t: (name, wall ms, cpu ms) x scale."""
    out = [Span("run_sequence", t, t + 1000 * MS, 900 * MS, MAIN, -1, request)]
    for name, wall, cpu in (("disc_init", 50, 10), ("scan", 300, 250), ("scan_prepare", 2, 1),
                            ("scan_forward", 40, 30), ("scan_forward", 40, 30),
                            ("scan_insert", 20, 15), ("scan_resolve", 30, 20),
                            ("label_download", 6, 5), ("png_write", 70, 60)):
        out.append(Span(name, t, t + scale * wall * MS, scale * cpu * MS, MAIN, 0, request))
    return out


@pytest.fixture
def recorded(monkeypatch):
    """A warm-up sequence (request w#0, ten times the window's times), then
    the window's two: 5 frames and 1 object (a#1), 9 frames and 2 objects
    (b#2): 14 frames, 12 tracked, 3 objects."""
    spans = (sequence_spans("w#0", 0, 10) + sequence_spans("a#1", 10_000 * MS, 1)
             + sequence_spans("b#2", 20_000 * MS, 1)
             + [Span("run_dataset", 0, 30_000 * MS, 0, MAIN, -1, None)])
    counts = {"w#0": 7, "a#1": 1, "b#2": 2}
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "counts", lambda requests=None: {"resolves": sum(
        n for r, n in counts.items() if requests is None or r in requests)})
    records = [{"frames": 5, "objects": 1}, {"frames": 9, "objects": 2}]
    return {"records": records}


@pytest.mark.parametrize("name,want", [
    ("png_write_ms_per_frame", 2 * 70 / 14),
    ("label_download_ms_per_frame", 2 * 6 / 12),
    ("scan_prepare_host_ms_per_frame", 2 * 1 / 12),
    ("scan_forward_host_ms_per_frame", 2 * 60 / 12),
    ("scan_insert_host_ms_per_frame", 2 * 15 / 12),
    ("scan_resolve_host_ms_per_frame", 2 * 20 / 12),
    ("resolves_per_frame", 3 / 12),
    ("disc_init_host_ms_per_object", 2 * 10 / 3)])
def test_span_readers_take_the_windows_requests(recorded, name, want):
    assert core.reader(name)(recorded) == pytest.approx(want)


def test_span_readers_need_a_span_of_every_window_sequence(recorded):
    recorded["records"] = recorded["records"] * 2
    for name in NEW:
        assert core.reader(name)(dict(recorded, trace_window=(0, 1),
                                      device_intervals=[])) is None, name


def test_unspanned_idle_share_on_a_known_timeline(monkeypatch):
    """Over [0, 100): the device busy over [10, 30) and [60, 70), so 70
    idle. On the issuing thread `scan` is open over [5, 50) and
    `png_write` over [75, 90): 40 of the idle time named. The entry points
    and another thread's span name nothing: 30 / 70 unnamed."""
    spans = [Span("run_dataset", 0, 100, 0, MAIN, -1, None),
             Span("run_sequence", 0, 100, 0, MAIN, 0, "s#0"),
             Span("png_write", 75, 90, 0, MAIN, 0, "s#0"),
             Span("scan", 5, 50, 0, MAIN, 1, "s#0"),
             Span("augment", 0, 100, 0, OTHER, -1, None)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    ctx = {"records": [{"frames": 3, "objects": 1}], "trace_window": (0, 100),
           "device_intervals": [("k", 60, 70), ("k", 10, 30)][::-1]}
    read = core.reader("device_idle_unspanned_pct.track")
    assert read(ctx) == pytest.approx(100 * 30 / 70)
    assert read({"records": ctx["records"]}) is None          # no device trace
    assert read(dict(ctx, device_intervals=[("k", 0, 100)])) is None       # never idle


def test_every_new_reader_is_silent_on_a_port_without_the_recorder(monkeypatch, recorded):
    monkeypatch.delattr(profiling, "spans")
    for name in NEW:
        assert core.reader(name)(dict(recorded, trace_window=(0, 1),
                                      device_intervals=[])) is None, name


def test_traced_run_reads_the_ports_spans(tiny):
    """The tiny traced run on the CPU: every new reader but the device
    trace's reads, and the scan's four steps together hold no more than
    the scan phase's thread-CPU time."""
    result = core.run_cell(core.load_bench(), CELL, 2**31 + 11, 0.2, True, "cpu", None, tiny)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name in NEW[:-1]:
        assert got[name] > 0, name
    assert "device_idle_unspanned_pct.track" not in got
    steps = sum(got[f"scan_{s}_host_ms_per_frame"] for s in
                ("prepare", "forward", "insert", "resolve"))
    assert 0.5 * got["scan_host_ms_per_frame"] < steps <= got["scan_host_ms_per_frame"]
