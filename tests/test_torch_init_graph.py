"""When the target model's two-phase init may run as a CUDA graph, on the CPU.

`disc_init` is split into a body of tensors in and tensors out
(`_init_body`, what an init graph captures) and a wrapper that builds the
weights and the state; the split gives the former single function's results
bit for bit. `init_eager_reasons` names each fact that keeps an init eager
(the CPU, the residual form, loss trajectories, a gradient wanted), and where
it names any, `disc_init_graphed` never consults the graph cache and gives
`disc_init`'s results. `init_graph_key` tells apart every change that alters
the captured work. What a graph captures, run through the cache's static
inputs with the graph replaced by a plain call, gives the eager init bit for
bit. The trainer's cold start and `ml_disc_init` never take the graph. The
graphs themselves are held against the eager init on the card
(tests/test_torch_cuda.py).
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from frtm_tpu_torch.config import DiscConfig
from frtm_tpu_torch.models import discriminator as td
from frtm_tpu_torch.models.memory import memory_init
from frtm_tpu_torch.models.multilayer import ml_disc_init
from frtm_tpu_torch.models.solver import init_cg_state
from frtm_tpu_torch.utils import cuda_graphs, profiling
from frtm_tpu_torch.utils.cuda_graphs import GraphCache

torch.set_num_threads(2)

CFG = DiscConfig(in_channels=32, c_channels=8, init_iters=(3, 5), update_iters=(3,),
                 memory_size=8, train_skipping=2)


def _inputs(cfg=CFG, n=3, k=3, hw=(6, 8), seed=0):
    """Starting weights of n lanes, (n, k, Cin, h, w) features and
    (n, k, 1, 4h, 4w) uint8 masks, as the fused tracker hands them over."""
    g = torch.Generator().manual_seed(seed)
    h, w = hw
    feats = torch.randn((n, k, cfg.in_channels, h, w), generator=g)
    labels = torch.zeros((n, k, 1, 4 * h, 4 * w), dtype=torch.uint8)
    for i in range(n):
        for j in range(k):
            labels[i, j, :, 4 + i:15 - j, 6 + j:20 - i] = 1
    p0 = td.init_disc_params(cfg, g, "cpu")
    return td.repeat_params(p0, n), feats, labels


def _old_disc_init(params, features, labels, cfg, collect_losses=False):
    """disc_init as one function, before the split."""
    pw = td.compute_pixel_weights(labels, cfg)
    N, K = features.shape[:2]
    score_hw = tuple(features.shape[-2:])

    mem1 = memory_init(K, features, labels, pw)
    theta = (params.project, params.filter)
    out1 = td._solve(mem1, cfg.filter_reg, cfg.precond, td._joint_net, theta,
                     init_cg_state(theta), cfg.init_iters, cfg, score_hw, collect_losses)
    params = td.DiscParams(*out1[0])
    del mem1

    mem2 = memory_init(cfg.memory_size, td.lane_project(features, params.project), labels, pw)
    theta_f = (params.filter,)
    out2 = td._solve(mem2, cfg.filter_reg[1:], cfg.precond[1:], td._filter_net, theta_f,
                     init_cg_state(theta_f), cfg.update_iters, cfg, score_hw, collect_losses)
    params = params._replace(filter=out2[0][0])
    state = td.DiscState(memory=mem2, cg=out2[1], frame_num=[0] * N,
                         n_resolves=torch.zeros(N, dtype=torch.int64, device=features.device))
    if collect_losses:
        return params, state, {"init": out1[2], "update": out2[2]}
    return params, state


def _tensors(params, state):
    """Every tensor of an init's result, in a fixed order."""
    m, cg = state.memory, state.cg
    return (params.project, params.filter, m.samples, m.labels, m.pixel_weights, m.weights,
            m.current_size, m.prev_ind, *cg.p, *cg.r_prev, cg.rho, cg.have_p, cg.step_alpha,
            state.n_resolves)


def _assert_same_init(got, want):
    assert got[1].frame_num == want[1].frame_num
    a, b = _tensors(*got[:2]), _tensors(*want[:2])
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.fixture
def cache(monkeypatch):
    """A fresh graph cache in the module's place, to see whether a call
    consulted it."""
    fresh = GraphCache(maxsize=4)
    monkeypatch.setattr(td, "INIT_GRAPHS", fresh)
    return fresh


@pytest.mark.parametrize("solver", ["stencil", "residual"])
@pytest.mark.parametrize("losses", [False, True])
@pytest.mark.parametrize("n", [1, 3])
def test_the_split_init_equals_the_single_function(solver, losses, n):
    """The body and the wrapper give what the single function gave, bit for
    bit: weights, the memory's six buffers, the CG state, the counters and,
    with collect_losses, both loss trajectories."""
    cfg = replace(CFG, solver=solver)
    params, feats, labels = _inputs(cfg, n=n)
    with torch.no_grad():
        want = _old_disc_init(params, feats, labels, cfg, losses)
        got = td.disc_init(params, feats, labels, cfg, losses)
    _assert_same_init(got, want)
    if losses:
        assert got[2].keys() == want[2].keys() == {"init", "update"}
        for key in ("init", "update"):
            assert torch.equal(got[2][key], want[2][key])


@pytest.mark.parametrize("case,reason", [
    ("cpu", "not on CUDA"), ("residual", "the residual form"),
    ("losses", "loss trajectories"), ("grad", "a gradient is wanted")])
def test_init_eager_reasons_keep_the_init_eager(cache, case, reason):
    """Each case is named, and disc_init_graphed runs the eager code: the
    same weights and state as disc_init, one `inits` and an `init_replays`
    of 0 a call, and the cache untouched."""
    cfg = replace(CFG, solver="residual") if case == "residual" else CFG
    params, feats, labels = _inputs(cfg)
    if case == "grad":
        feats = feats.clone().requires_grad_()
    with torch.enable_grad() if case == "grad" else torch.no_grad():
        reasons = td.init_eager_reasons(params, feats, labels, cfg,
                                        collect_losses=case == "losses")
        assert reason in reasons and "not on CUDA" in reasons
        want = td.disc_init(params, feats, labels, cfg)
        profiling.reset()
        try:
            with profiling.recording():
                got = td.disc_init_graphed(params, feats, labels, cfg)
            counts = profiling.counts()
        finally:
            profiling.reset()
    assert counts == {"inits": 1, "init_replays": 0}
    _assert_same_init(got, want)
    assert len(cache) == 0


def test_grad_enabled_with_nothing_to_differentiate_is_no_reason():
    with torch.enable_grad():
        assert td.init_eager_reasons(*_inputs(), CFG) == ["not on CUDA"]


@pytest.mark.parametrize("change", [
    "objects", "samples", "frame_size", "label_dtype", "init_iters", "update_iters",
    "memory_size", "filter_reg", "precond", "forgetting", "c_channels", "pixel_weighting",
    "pixel_weighting_tf", "per_frame", "distractor_mult"])
def test_init_graph_key_tells_apart_what_changes_the_captured_work(change):
    """The key of a changed lane count, input shape or dtype, schedule,
    memory, regularisation or weighting constant differs from the base key;
    a second base problem, and a change the init does not read (the
    insert's learning rate and update method, the cadence, the scores'
    clamp), keep it."""
    cfg, shape = CFG, {}
    if change == "objects":
        shape = dict(n=2)
    elif change == "samples":
        shape = dict(k=4)
    elif change == "frame_size":
        shape = dict(hw=(7, 8))
    elif change == "init_iters":
        cfg = replace(CFG, init_iters=(3, 4))
    elif change == "update_iters":
        cfg = replace(CFG, update_iters=(4,))
    elif change == "memory_size":
        cfg = replace(CFG, memory_size=10)
    elif change == "filter_reg":
        cfg = replace(CFG, filter_reg=(1e-4, 2e-2))
    elif change == "precond":
        cfg = replace(CFG, precond=(2e-4, 1e-2))
    elif change == "forgetting":
        cfg = replace(CFG, cg_forgetting_rate=500)
    elif change == "c_channels":
        cfg = replace(CFG, c_channels=4)
    elif change == "pixel_weighting":
        cfg = replace(CFG, pixel_weighting_method="fixed")
    elif change == "pixel_weighting_tf":
        cfg = replace(CFG, pixel_weighting_tf=0.2)
    elif change == "per_frame":
        cfg = replace(CFG, pixel_weighting_per_frame=False)
    elif change == "distractor_mult":
        cfg = replace(CFG, distractor_mult=2.0)
    base = td.init_graph_key(*_inputs(), CFG)
    assert td.init_graph_key(*_inputs(seed=1), CFG) == base
    assert td.init_graph_key(*_inputs(), replace(
        CFG, learning_rate=0.5, train_skipping=3, update_method="raw",
        clamp_output=True)) == base
    params, feats, labels = _inputs(cfg, **shape)
    if change == "label_dtype":
        labels = labels.float()
    assert td.init_graph_key(params, feats, labels, cfg) != base


class _EagerGraph:
    """A stand-in for a captured graph on the CPU: the same static inputs,
    copied into at each replay, and the function run on them."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, tuple(t.clone() for t in inputs)

    def replay(self, inputs):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        return tuple(t.clone() for t in self.fn(*self.inputs))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_the_captured_init_gives_the_eager_one(cache, monkeypatch, n):
    """What an init graph would capture, run on the CPU through the cache's
    static-input path (the graph replaced by a plain call, the eager rule
    waived): three inits of three problems of one key, the first eager, the
    second captured, the third replayed, each bit for bit as disc_init of the
    same problem; two of the three count a replay. A replayed result is the
    caller's own: an insert into its memory and a re-solve leave the next
    replay's result as disc_init gives it."""
    problems = [_inputs(n=n, seed=s) for s in range(3)]
    with torch.no_grad():
        want = [td.disc_init(*p, CFG) for p in problems]
        monkeypatch.setattr(cuda_graphs, "_Graph", _EagerGraph)
        monkeypatch.setattr(td, "init_eager_reasons", lambda *a, **k: [])
        profiling.reset()
        try:
            with profiling.recording():
                got = []
                for p in problems:
                    params, state = td.disc_init_graphed(*p, CFG)
                    got.append(_tensors(params, state))
                    got[-1] = tuple(t.clone() for t in got[-1])
                    c = torch.randn((n, CFG.c_channels, 6, 8))
                    td.insert_sample(state, c, torch.ones((n, 1, 24, 32)),
                                     torch.ones(n, dtype=torch.bool), [True] * n, CFG)
                    td.filter_resolve(params, state, CFG)
            counts = profiling.counts()
        finally:
            profiling.reset()
        again = td.disc_init_graphed(*problems[0], CFG)
    assert counts == {"inits": 3, "init_replays": 2} and cache.captured() == 1
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, _tensors(*b)))
    _assert_same_init(again, want[0])


def test_the_trainers_cold_start_and_ml_disc_init_stay_eager(cache, monkeypatch):
    """With the eager rule waived, neither the trainer's cold start (a lane a
    unique miss) nor ml_disc_init consults the init graphs, and each gives
    disc_init's results."""
    from frtm_tpu_torch.data.training_datasets import SampleSpec
    from frtm_tpu_torch.runtime.trainer import TModelCache, TrainerModel
    from frtm_tpu_torch.utils.profiling import PhaseTimer
    monkeypatch.setattr(cuda_graphs, "_Graph", _EagerGraph)
    monkeypatch.setattr(td, "init_eager_reasons", lambda *a, **k: [])
    params, feats, labels = _inputs(n=2)

    class Augmenter:
        def augment_first_frame(self, image, label, rng):
            i = int(image[0, 0, 0])
            return (torch.full((3, 3, 24, 32), i, dtype=torch.uint8), labels[i])

    tm = TrainerModel.__new__(TrainerModel)
    tm.disc_cfg, tm.device, tm.cache = CFG, torch.device("cpu"), TModelCache(None, enable=False)
    tm.augmenter, tm.timer = Augmenter(), PhaseTimer(sync=False)
    tm.disc_params0 = td.DiscParams(params.project[0], params.filter[0])
    tm._extract_flat = lambda frames: feats.flatten(0, 1)
    images = [np.full((24, 32, 3), i, np.uint8) for i in range(2)]
    specs = [SampleSpec(seq_name="s", obj_id=i + 1, frames=[0, 1, 2], frame0_id=0)
             for i in range(2)]
    with torch.no_grad():
        want = td.disc_init(params, feats, labels, CFG)
        tdisc, hits = tm.build_disc_batch(images, [None, None], specs)
        ml_params, ml_states = ml_disc_init({"layer4": params, "layer3": params},
                                            {"layer4": feats, "layer3": feats}, labels,
                                            {"layer4": CFG, "layer3": CFG})
    assert hits == 0 and len(cache) == 0
    assert torch.equal(tdisc.project, want[0].project)
    assert torch.equal(tdisc.filter, want[0].filter)
    for L in ("layer4", "layer3"):
        _assert_same_init((ml_params[L], ml_states[L]), want)
