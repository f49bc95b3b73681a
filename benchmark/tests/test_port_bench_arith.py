"""The arithmetic of the metrics: the window rate, seq_s_p90, the idle share
as an interval union, mfu, and the rooflines against PERF.md's bounds."""
import statistics

import pytest

from benchmark.harness import core, track
from benchmark.rooflines import conv3x3_cout1, frtm_model, peaks, pyrup, warp_affine


def records(seconds, frames=50, objects=2):
    return [{"frames": frames, "objects": objects, "fps": frames / s, "seconds": s,
             "phases": {}} for s in seconds]


def test_seq_readers():
    ctx = {"records": records([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0])}
    assert core.reader("seq_s_p90")(ctx) == statistics.quantiles(
        [r["seconds"] for r in ctx["records"]], n=10)[8]
    assert core.reader("seq_fps_mean")(ctx) == pytest.approx(
        sum(50 / s for s in range(1, 11)) / 10)
    assert core.reader("seq_s_p90")({"records": records([1.0])}) is None


def test_phase_readers_per_unit():
    recs = records([1.0, 1.0], frames=11, objects=3)
    for r in recs:
        r["phases"] = {"scan": {"total_s": 0.5, "cpu_ms_per_call": 100.0, "count": 2},
                       "disc_init": {"total_s": 0.3, "cpu_ms_per_call": 1.0, "count": 1}}
    ctx = {"records": recs}
    assert core.reader("scan_ms_per_frame")(ctx) == pytest.approx(1000 * 1.0 / 20)
    assert core.reader("scan_host_ms_per_frame")(ctx) == pytest.approx(1000 * 0.4 / 20)
    assert core.reader("disc_init_ms_per_object")(ctx) == pytest.approx(1000 * 0.6 / 6)
    assert core.reader("augment_ms_per_object")(ctx) is None


def test_idle_share_is_an_interval_union():
    ns = 1_000_000_000
    iv = [("a", 0, 4 * ns // 10), ("b", 2 * ns // 10, 5 * ns // 10),   # overlap
          ("c", 7 * ns // 10, 8 * ns // 10), ("d", 9 * ns // 10, 12 * ns // 10)]
    assert track.busy_seconds(iv, 0, ns) == pytest.approx(0.5 + 0.1 + 0.1)
    ctx = {"trace_window": (0, ns), "device_intervals": iv}
    assert core.reader("device_idle_pct.track")(ctx) == pytest.approx(30.0)
    spans = [("scan", 0, ns, 1), ("png_write", 5 * ns // 10, 7 * ns // 10, 1)]
    busy, window, gaps = track.idle_gaps(iv, 0, ns, spans)
    assert window == 1.0 and busy == pytest.approx(0.7)
    assert dict(gaps) == pytest.approx({"png_write": 0.2, "scan": 0.1})


def test_window_rate_and_mfu():
    cfg = {"arch": "resnet101", "refnet_layers": ["layer5", "layer4", "layer3", "layer2"],
           "layer": "layer4", "refnet_channels": 64, "c_channels": 96, "memory_size": 80,
           "update_iters": [10], "init_iters": [5, 10, 10, 10, 10], "num_aug": 5,
           "train_skipping": 8, "compute_dtype": "bfloat16"}
    recs = records([2.0, 3.0], frames=67)
    flops = track.window_flops(cfg, (480, 854), recs)
    one = frtm_model.sequence_flops(cfg, 480, 854, 67, 2)
    assert flops["compute"] == pytest.approx(2 * one["compute"])
    ctx = {"config": cfg, "flops": flops, "window_s": 10.0}
    want = 100 * (flops["compute"] / 989e12 + flops["float32"] / 67e12) / 10.0
    assert core.reader("mfu.track")(ctx) == pytest.approx(want)
    # about 128 GFLOP a ResNet-101 frame at 480x854 (0.13 ms at the bf16 peak)
    assert 100e9 < frtm_model.backbone("resnet101", 480, 854) < 150e9


def test_rooflines_reproduce_the_kernel_table():
    """PERF.md's kernel table: bytes read and written once over 3.35 TB/s."""
    b, f = pyrup.cost([(1, 32, 120, 214)], "float32")
    assert b == 16_435_200
    assert round(peaks.bound_seconds(b, f, "float32") * 1e3, 6) == 0.004906
    b, f = conv3x3_cout1.cost([(1, 16, 480, 854), (1, 16, 3, 3), (1,)], "float32")
    assert b - 16 * 9 * 4 - 4 == 27_874_560
    assert round(peaks.bound_seconds(b, f, "float32") * 1e3, 6) == 0.008321
    # a warp reads at most its source and at least nothing beyond the output's footprint
    b, _ = warp_affine.cost([(3, 480, 854)], "float32", (1.0, (480, 854), "bicubic"))
    assert b == 2 * 3 * 480 * 854 * 4
    b, _ = warp_affine.cost([(3, 480, 854)], "float32", (100.0, (480, 854), "bicubic"))
    assert b == 2 * 3 * 480 * 854 * 4


def test_roofline_reader_sums_bounds_over_time():
    calls = [dict(kernel="pyrup", shapes=[(1, 32, 120, 214)], dtype="float32", extra=None,
                  ms=0.008), dict(kernel="pyrup", shapes=[(1, 32, 120, 214)],
                                  dtype="float32", extra=None, ms=0.012)]
    got = core.reader("pyrup_roofline")({"kernel_calls": calls})
    assert got == pytest.approx(100 * 2 * 0.004906e-3 / 0.020e-3, rel=1e-3)
    assert core.reader("conv3x3_cout1_roofline")({"kernel_calls": calls}) is None
