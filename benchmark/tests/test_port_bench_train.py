"""The training cell on the CPU at a tiny size (the port's kernels in their
plain versions): the harness's result line and its check, the traced run's
program metrics, each fault planted under the timed path
(harness/train_faults.py) and the control in the port's place reading not
correct; the backward kernels' rooflines against PERF.md's bounds, the
train step's model FLOPs against a hand count, and the reference's
imports."""
import pytest

from benchmark.harness import core
from benchmark.harness.train_faults import FAULTS
from benchmark.rooflines import conv3x3_cout1_dw, conv3x3_cout1_dx, frtm_train, peaks, pyrup_bwd

CELL = "train.rn101"
# resnet18 at 64x112, batch 2 of 3 frames, a pool of 4, 8 samples an epoch
TINY = {"config": {"arch": "resnet18", "batch_size": 2, "num_aug": 3, "init_iters": [3, 5],
                   "update_iters": [3], "c_channels": 16},
        "mix": {"frame_size": [64, 112], "epoch_samples": 8,
                "sequences": [{"name": f"p{i}", "frames": 3, "objects": [[22 + i, 30]]}
                              for i in range(4)]}}
# The tiny cell's sound readings are under 5e-5 (loss 6e-8, gradients 2e-6,
# updates 4e-5, running statistics 4e-7), so it is judged against these; the
# cell's own limits are held against the faults at the cell's size on the
# card (PERF.md).
TIGHT = {"loss_gap": 1e-6, "grad_gap": 1e-4, "update_gap": 2e-4, "bn_stat_gap": 1e-5}


def run(trace=False, seed=2147483913, limits=None, **extra):
    overrides = dict(TINY, limits=limits) if limits else TINY
    return core.run_cell(core.load_bench(), CELL, seed, 0.3, trace, "cpu", None, overrides,
                         extra=extra or None)


def test_result_line_and_check():
    result = run()
    assert result["correct"] is True, result["limits"]
    assert set(result["metrics"]) == {"fps", "setup_s"}
    assert result["metrics"]["fps"]["value"] > 0
    assert set(result["limits"]) == {"loss_gap", "grad_gap", "update_gap", "bn_stat_gap"}
    assert all(v["value"] <= TIGHT[k] for k, v in result["limits"].items())
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_traced_run_reads_the_program_metrics():
    result = run(trace=True, seed=7)
    got = result["metrics"]
    for name in ("train_step_ms", "train_forward_ms_per_step", "train_backward_ms_per_step",
                 "optim_step_ms_per_step", "data_wait_ms_per_step", "tmodel_load_ms_per_step"):
        assert got[name]["value"] > 0, name
    assert got["tmodel_hit_pct"]["value"] == 100.0
    # no card: no kernel timed, no device trace; those readers stay silent
    for name in ("kernels_roofline.train", "pyrup_bwd_roofline", "device_idle_pct.train"):
        assert name not in got
    assert "fps" not in got and result["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch.setattr)
    result = run(limits=TIGHT)
    assert result["correct"] is False, result["limits"]


def test_the_control_in_the_ports_place_is_not_correct():
    """The control (TF32: the scores' and refiner's convolution operands
    rounded to 10 mantissa bits) in the port's place: its numbers are the
    ones compared, each at or above the port's, and one breaks its limit."""
    result = run(limits=TIGHT, control=True)
    assert result["correct"] is False, result["limits"]
    words = next(n for n in result["_notes"] if n.startswith("port ")).split()[1:]
    port = {words[i]: float(words[i + 1]) for i in range(0, len(words), 2)}
    for name, v in result["limits"].items():
        assert port[name] <= TIGHT[name], name
        assert v["value"] >= port[name], name


def test_backward_rooflines_reproduce_the_kernel_table():
    """PERF.md's kernel table, section 6: bytes read and written once over
    3.35 TB/s."""
    def ms(cost, shapes):
        b, f = cost(shapes, "float32")
        return round(peaks.bound_seconds(b, f, "float32") * 1e3, 6)
    # pyrup_bwd's rows name the forward's input; its call takes the gradient
    assert ms(pyrup_bwd.cost, [(16, 32, 240, 428), None]) == 0.078496
    assert ms(pyrup_bwd.cost, [(16, 16, 480, 856), None]) == 0.156993
    assert ms(conv3x3_cout1_dx.cost, [(16, 1, 480, 854), (1, 16, 3, 3), None]) == 0.133132
    assert ms(conv3x3_cout1_dw.cost, [(16, 16, 480, 854), (16, 1, 480, 854)]) == 0.133132
    b, f = conv3x3_cout1_dw.cost([(2, 3, 4, 5), (2, 1, 4, 5)], "float32")
    assert b == (120 + 40 + 28) * 4 and f == 2 * 9 * 3 * 40 + 40


def test_train_step_flops_by_hand():
    """resnet18 at 32x32, one refinement layer (layer2) of 4 channels, the
    target model on layer2 with 2 channels, batch 3 of 2 frames."""
    cfg = {"arch": "resnet18", "refnet_layers": ["layer2"], "refnet_channels": 4,
           "layer": "layer2", "c_channels": 2}

    def conv(cin, cout, k, h, w):
        return 2.0 * cin * cout * k * k * h * w
    # the stem at 16x16, layer2 (= the first residual stage, 64 channels) at 8x8
    back = conv(3, 64, 7, 16, 16) + 2 * (2 * conv(64, 64, 3, 8, 8))
    target = conv(64, 2, 1, 8, 8) + conv(2, 1, 3, 8, 8)
    reduce0, reduce1 = conv(64, 4, 1, 8, 8), conv(4, 4, 1, 8, 8)
    tse = 2 * conv(5, 5, 3, 8, 8) + conv(5, 4, 3, 8, 8)
    rrbs = 2 * (conv(4, 4, 1, 8, 8) + 2 * conv(4, 4, 3, 8, 8))
    head = conv(4, 2, 3, 16, 16) + conv(2, 1, 3, 32, 32)
    forward = reduce0 + reduce1 + tse + rrbs + head
    per_frame = back + target + 3 * forward - reduce0
    assert frtm_train.frame_flops(cfg, 32, 32) == pytest.approx(per_frame, rel=1e-12)
    assert frtm_train.step_flops(cfg, 32, 32, 3, 2) == pytest.approx(3 * per_frame, rel=1e-12)
    # the cell's step: about 6.4 TFLOP (96 ms at the float32 peak)
    rn101 = {"arch": "resnet101", "refnet_layers": ["layer5", "layer4", "layer3", "layer2"],
             "refnet_channels": 64, "layer": "layer4", "c_channels": 32}
    assert 6.3e12 < frtm_train.step_flops(rn101, 480, 854, 16, 3) < 6.5e12


def test_the_reference_step_imports_no_kernel_and_no_jax():
    from benchmark.tests.test_port_bench_imports import BENCH_DIR, top_level_imports
    path = BENCH_DIR / "reference" / "trainer.py"
    names = set(top_level_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "frtm_tpu", "frtm_tpu_torch"}
    assert "ops.kernels" not in path.read_text()
