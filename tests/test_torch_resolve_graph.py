"""When the target model's filter re-solve may run as a CUDA graph, on the CPU.

`eager_reasons` names each fact that keeps a re-solve eager (the CPU, the
residual form, loss trajectories, a gradient wanted), and where it names any,
`filter_resolve` and `resolve_due` never consult the graph cache and give the
eager functions' results bit for bit. `resolve_graph_key` tells apart every
change that alters the captured work. What a graph captures, run through
the cache's static inputs with the graph replaced by a plain call, gives the
eager re-solve bit for bit. (A fused run on the CPU counts its re-solves and
no replay: test_torch_sequence_tracker.py's
test_fused_tracker_records_the_scans_steps.) The graphs themselves are held
against the eager re-solve on the card (tests/test_torch_cuda.py).
"""
from dataclasses import replace

import pytest
import torch

from frtm_tpu_torch.config import DiscConfig
from frtm_tpu_torch.models import discriminator as td
from frtm_tpu_torch.utils import profiling
from frtm_tpu_torch.utils.cuda_graphs import GraphCache

torch.set_num_threads(2)

CFG = DiscConfig(in_channels=32, c_channels=8, init_iters=(3, 5), update_iters=(3,),
                 memory_size=8, train_skipping=2)


def _models(cfg=CFG, n=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((n, 3, cfg.in_channels, 6, 8), generator=g)
    labels = torch.zeros((n, 3, 1, 24, 32))
    for i in range(n):
        labels[i, :, :, 4 + i:15, 6:20 - i] = 1.0
    p0 = td.init_disc_params(cfg, g, "cpu")
    return td.disc_init(td.repeat_params(p0, n), feats, labels, cfg)


@pytest.fixture
def cache(monkeypatch):
    """A fresh graph cache in the module's place, to see whether a call
    consulted it."""
    fresh = GraphCache(maxsize=4)
    monkeypatch.setattr(td, "RESOLVE_GRAPHS", fresh)
    return fresh


def _clone(state):
    cg, m = state.cg, state.memory
    return replace(state, memory=replace(m, weights=m.weights.clone()),
                   cg=replace(cg, p=tuple(t.clone() for t in cg.p),
                              r_prev=tuple(t.clone() for t in cg.r_prev),
                              rho=cg.rho.clone(), have_p=cg.have_p.clone(),
                              step_alpha=cg.step_alpha.clone()))


@pytest.mark.parametrize("case,reason", [
    ("cpu", "not on CUDA"), ("residual", "the residual form"),
    ("losses", "loss trajectories"), ("grad", "a gradient is wanted")])
def test_eager_reasons_keep_the_resolve_eager(cache, case, reason):
    """Each case is named, and the re-solve runs the eager code: the same
    filters and CG state as `_filter_resolve_eager` and its per-lane select,
    one `resolve_replays` of 0 a resolve_due call, and the cache untouched."""
    cfg = replace(CFG, solver="residual") if case == "residual" else CFG
    params, state = _models(cfg)
    losses = case == "losses"
    if case == "grad":
        params = params._replace(filter=params.filter.clone().requires_grad_())
    with torch.enable_grad() if case == "grad" else torch.no_grad():
        reasons = td.eager_reasons(params, state, cfg, collect_losses=losses)
        assert reason in reasons and "not on CUDA" in reasons
        want = td._filter_resolve_eager(params, _clone(state), cfg, losses)
        got = td.filter_resolve(params, _clone(state), cfg, losses)
        for a, b in zip((want[0].filter, *want[1].p, want[1].rho, want[1].step_alpha),
                        (got[0].filter, *got[1].p, got[1].rho, got[1].step_alpha)):
            assert torch.equal(a, b)
        if losses:
            assert torch.equal(want[2], got[2])
        due = torch.tensor([True, False, True])
        before = params.filter.detach().clone()
        profiling.reset()
        try:
            with profiling.recording():
                taken = td.resolve_due(params, state, due, cfg)
            counts = profiling.counts()
        finally:
            profiling.reset()
    assert counts == {"resolve_replays": 0}
    assert torch.equal(taken.filter[0], want[0].filter[0])
    assert torch.equal(taken.filter[1], before[1])
    assert torch.equal(taken.filter[2], want[0].filter[2])
    assert state.n_resolves.tolist() == [1, 0, 1]
    assert len(cache) == 0


def test_grad_enabled_with_nothing_to_differentiate_is_no_reason():
    params, state = _models()
    with torch.enable_grad():
        assert td.eager_reasons(params, state, CFG) == ["not on CUDA"]


@pytest.mark.parametrize("change", [
    "objects", "memory_size", "update_iters", "filter_reg", "precond", "precond_lr",
    "c_channels"])
def test_graph_key_tells_apart_what_changes_the_captured_work(change):
    """The key of a changed lane count, memory, schedule or constant differs
    from the base key; a second base problem, and a change the re-solve does
    not read (the insert's learning rate, the cadence), keep it."""
    cfg, n = CFG, 3
    if change == "objects":
        n = 2
    elif change == "memory_size":
        cfg = replace(CFG, memory_size=10)
    elif change == "update_iters":
        cfg = replace(CFG, update_iters=(4,))
    elif change == "filter_reg":
        cfg = replace(CFG, filter_reg=(1e-4, 2e-2))
    elif change == "precond":
        cfg = replace(CFG, precond=(1e-4, 2e-2))
    elif change == "precond_lr":
        cfg = replace(CFG, precond_lr=0.2)
    else:
        cfg = replace(CFG, c_channels=4)
    base = td.resolve_graph_key(*_models(), CFG)
    assert td.resolve_graph_key(*_models(seed=1), CFG) == base
    assert td.resolve_graph_key(*_models(), replace(CFG, learning_rate=0.5,
                                                    train_skipping=3)) == base
    assert td.resolve_graph_key(*_models(cfg, n), cfg) != base


class _EagerGraph:
    """A stand-in for a captured graph on the CPU: the same static inputs,
    copied into at each replay, and the function run on them."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, tuple(t.clone() for t in inputs)

    def replay(self, inputs):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        return tuple(t.clone() for t in self.fn(*self.inputs))


@pytest.mark.parametrize("n", [1, 3])
def test_the_captured_function_gives_the_eager_resolve(cache, monkeypatch, n):
    """What a graph would capture, run on the CPU through the cache's
    static-input path (the graph replaced by a plain call, the eager rule
    waived): three resolve_due calls with alternating due masks, then a
    filter_resolve, bit for bit as the eager calls; the first call of the key
    is eager and the other two resolve_due calls count a replay."""
    from frtm_tpu_torch.utils import cuda_graphs
    dues = [[k % 2 == 0 for k in range(n)], [k % 2 == 1 for k in range(n)], [True] * n]

    def run():
        params, state = _models(n=n)
        out = []
        for due in dues:
            params = td.resolve_due(params, state, torch.tensor(due), CFG)
            out.append((params.filter, state.cg))
        params, cg = td.filter_resolve(params, state, CFG)
        return out + [(params.filter, cg)]

    want = run()
    monkeypatch.setattr(cuda_graphs, "_Graph", _EagerGraph)
    monkeypatch.setattr(td, "eager_reasons", lambda *a, **k: [])
    profiling.reset()
    try:
        with profiling.recording():
            got = run()
        counts = profiling.counts()
    finally:
        profiling.reset()
    assert counts == {"resolve_replays": 2} and cache.captured() == 1
    for (f, cg), (f0, cg0) in zip(got, want):
        for a, b in ((f, f0), (cg.p[0], cg0.p[0]), (cg.r_prev[0], cg0.r_prev[0]),
                     (cg.rho, cg0.rho), (cg.have_p, cg0.have_p),
                     (cg.step_alpha, cg0.step_alpha)):
            assert torch.equal(a, b)
