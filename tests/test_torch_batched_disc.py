"""The target model's object axis: the port solves and updates N objects'
target models together, as frtm_tpu does with `jax.vmap`. Held here on the
CPU, on the same numpy inputs and starting weights:

* the batched disc_init, memory insert and filter re-solve at N = 3 against
  `jax.vmap` of frtm_tpu's per-object functions, in both solver forms, and
  two layers through ml_disc_init;
* each lane of the batched solve against the one-object solve (N = 1) of
  the same object, and N = 1 against frtm_tpu's per-object disc_init;
* the convolutions and batched products one init runs, the same number at
  N = 1 and N = 3;
* the trainer's cold start on three misses against frtm_tpu's
  `_init_disc_batch`;
* the fused tracker with three objects, one of them entering mid-sequence
  (lanes due on different frames), against frtm_tpu's fused tracker.

Tolerances, with the measured values. At these sizes the init is well
conditioned: frtm_tpu's own filters and scores move by 5e-7 to 1.7e-6 of
their peak when its input features move by 1e-6 (relative), and the test
that states this measures it again. Scores and filters are held within 1e-5
of their peak: the port against frtm_tpu measured at most 1.3e-6 (scores)
and 7.9e-7 (filters); a lane of the batched solve against the one-object
solve measured 0 (each lane is its own product in one batched matrix
product, which rounds as the one-object product does). Memory stores are
equal, weights within rtol 1e-6, loss trajectories within rtol 1e-4.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch.profiler import ProfilerActivity, profile

from frtm_tpu.models import discriminator as jd
from frtm_tpu.models import memory as jm
from frtm_tpu.models import multilayer as jml
from frtm_tpu_torch.config import DiscConfig, eval_config
from frtm_tpu_torch.models import discriminator as td
from frtm_tpu_torch.models import multilayer as tml
from frtm_tpu_torch.models.resnet import resnet_out_channels
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from frtm_tpu_torch.runtime.trainer import TModelCache
from frtm_tpu_torch.data.training_datasets import SampleSpec
from frtm_tpu_torch.utils.convert import (disc_params_from_jax, init_resnet,
                                          init_seg_network)
from test_torch_trainer import batch, jax_model, port_model, weights  # noqa: F401 (a fixture)
from test_torch_tracker import FreshBatches
from test_torch_sequence_tracker import SIZE

torch.set_num_threads(2)

CFG = dict(in_channels=32, c_channels=8, init_iters=(3, 5), update_iters=(3,),
           memory_size=8, train_skipping=2)
N = 3
TOL = 1e-5      # of the peak, for scores and filters (module docstring)


def t5(a):
    """(N, K, h, w, C) numpy -> (N, K, C, h, w) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 2)))


def oihw(a):
    """JAX weights with the object axis (N, kh, kw, i, o) -> (N, o, i, kh, kw)."""
    return np.transpose(np.asarray(a), (0, 4, 3, 1, 2))


def _problem(rng, n=N, K=3, h=6, w=8, stride=4, cin=CFG["in_channels"]):
    feats = rng.randn(n, K, h, w, cin).astype(np.float32)
    labels = np.zeros((n, K, h * stride, w * stride, 1), np.float32)
    for i in range(n):
        for k in range(K):
            y, x = rng.randint(0, h * stride - 10), rng.randint(0, w * stride - 10)
            labels[i, k, y:y + 9, x:x + 11] = 1.0
    return feats, labels


def _p0(jcfg):
    p0 = jd.init_disc_params(jax.random.PRNGKey(0), jcfg)
    return p0, disc_params_from_jax(np.asarray(p0.project), np.asarray(p0.filter))


def _jax_init(p0, feats, labels, jcfg, collect_losses=False):
    return jax.vmap(lambda f, l: jd.disc_init(p0, f, l, jcfg, collect_losses=collect_losses))(
        jnp.asarray(feats), jnp.asarray(labels))


def _scores(params, ft):
    """Port DiscParams of N objects on (B, h, w, C) features -> (N, B, h, w)."""
    s, _ = td.disc_apply(params, torch.from_numpy(np.moveaxis(ft, -1, 1)))
    return np.moveaxis(s.numpy(), 1, 0)


def _jax_scores(params, ft):
    return np.stack([np.asarray(jd.disc_apply(jax.tree.map(lambda x: x[i], params),
                                              jnp.asarray(ft))[0])[..., 0]
                     for i in range(params.project.shape[0])])


def _close_per_lane(got, want, tol=TOL):
    """Per lane (axis 0), within tol of that lane's peak; returns the worst
    relative gap."""
    worst = 0.0
    for g, w in zip(got, want):
        peak = float(np.abs(w).max())
        assert peak > 0
        gap = float(np.abs(g - w).max()) / peak
        assert gap <= tol, gap
        worst = max(worst, gap)
    return worst


@pytest.mark.parametrize("solver", ["stencil", "residual"])
def test_batched_init_matches_jax_vmap(rng, solver):
    """disc_init of three objects at once against jax.vmap(disc_init): the
    scores of each lane on new features, its filters and projections within
    1e-5 of their peak (measured 1.3e-6 and 7.9e-7), its memory (weights
    rtol 1e-6; labels, pixel weights and sizes equal) and its loss
    trajectories (rtol 1e-4)."""
    jcfg, tcfg = jd.DiscConfig(**CFG, solver=solver), DiscConfig(**CFG, solver=solver)
    p0, tp0 = _p0(jcfg)
    feats, labels = _problem(rng)
    jp, js, jl = _jax_init(p0, feats, labels, jcfg, collect_losses=True)
    tp, ts, tl = td.disc_init(td.repeat_params(tp0, N), t5(feats), t5(labels), tcfg,
                              collect_losses=True)
    ft = rng.randn(2, 6, 8, CFG["in_channels"]).astype(np.float32)
    _close_per_lane(_scores(tp, ft), _jax_scores(jp, ft))
    _close_per_lane(tp.filter.numpy(), oihw(jp.filter))
    _close_per_lane(tp.project.numpy(), oihw(jp.project))
    np.testing.assert_allclose(ts.memory.weights.numpy(), np.asarray(js.memory.weights),
                               rtol=1e-6)
    np.testing.assert_array_equal(ts.memory.labels.numpy(),
                                  np.moveaxis(np.asarray(js.memory.labels), -1, 2))
    np.testing.assert_allclose(ts.memory.pixel_weights.numpy(),
                               np.moveaxis(np.asarray(js.memory.pixel_weights), -1, 2),
                               rtol=1e-6)
    assert ts.memory.current_size.tolist() == np.asarray(js.memory.current_size).tolist()
    assert ts.frame_num == [0] * N and ts.n_resolves.tolist() == [0] * N
    for key in ("init", "update"):
        assert tl[key].shape == (N, len(CFG[f"{key}_iters"]) + 1)
        np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]), rtol=1e-4)


@pytest.mark.parametrize("solver", ["stencil", "residual"])
def test_batched_insert_and_resolve_match_jax_vmap(rng, solver):
    """Two tracked frames of three objects: one insert of all lanes per
    frame, gated per lane (lane 1 off on the first frame, so its slots and
    weights part from the others'; lane 2 not yet tracked on the first
    frame), against jax.vmap of frtm_tpu's insert (memory_update of
    online_update_weights, as its fused tracker's insert_sample); then one
    re-solve of all lanes that lanes 0 and 2 take, against jax.vmap of
    filter_resolve for those lanes and the old filter for lane 1. Stores and
    sizes equal, weights rtol 1e-6, scores within 1e-5 of their peak
    (measured 9.3e-7 and 1.3e-6)."""
    jcfg, tcfg = jd.DiscConfig(**CFG, solver=solver), DiscConfig(**CFG, solver=solver)
    p0, tp0 = _p0(jcfg)
    feats, labels = _problem(rng)
    jp, js = _jax_init(p0, feats, labels, jcfg)
    tp, ts = td.disc_init(td.repeat_params(tp0, N), t5(feats), t5(labels), tcfg)

    def jax_insert(state, c, ty, e):
        label, pw = jd.online_update_weights(ty, jcfg)
        return state._replace(memory=jm.memory_update(state.memory, c, label, pw,
                                                      jcfg.learning_rate, enabled=e))

    gates = [[True, False, False], [True, True, True]]
    actives = [[True, True, False], [True, True, True]]
    for enabled, active in zip(gates, actives):
        c = rng.randn(N, 6, 8, CFG["c_channels"]).astype(np.float32)
        y = np.zeros((N, 24, 32, 1), np.float32)
        y[:, 5:16, 6:18] = rng.rand(N, 11, 12, 1)
        js = jax.vmap(jax_insert)(js, jnp.asarray(c), jnp.asarray(y), jnp.asarray(enabled))
        td.insert_sample(ts, torch.from_numpy(np.moveaxis(c, -1, 1)),
                         torch.from_numpy(np.moveaxis(y, -1, 1)), torch.tensor(enabled),
                         active, tcfg)
        for a, b in ((ts.memory.samples, js.memory.samples), (ts.memory.labels, js.memory.labels),
                     (ts.memory.pixel_weights, js.memory.pixel_weights)):
            np.testing.assert_array_equal(a.numpy()[:, 3:], np.moveaxis(np.asarray(b), -1, 2)[:, 3:])
        np.testing.assert_allclose(ts.memory.weights.numpy(), np.asarray(js.memory.weights),
                                   rtol=1e-6)
        assert ts.memory.current_size.tolist() == np.asarray(js.memory.current_size).tolist()
        assert ts.memory.prev_ind.tolist() == np.asarray(js.memory.prev_ind).tolist()
    assert ts.frame_num == [2, 2, 1]
    assert ts.memory.current_size.tolist() == [5, 4, 4]

    jnew, _ = jax.vmap(lambda p, s: jd.filter_resolve(p, s, jcfg))(jp, js)
    before = tp.filter.clone()
    tp = td.resolve_due(tp, ts, torch.tensor([True, False, True]), tcfg)
    assert ts.n_resolves.tolist() == [1, 0, 1]
    assert torch.equal(tp.filter[1], before[1])
    ft = rng.randn(2, 6, 8, CFG["in_channels"]).astype(np.float32)
    want = _jax_scores(jnew, ft)
    want[1] = _jax_scores(jp, ft)[1]
    _close_per_lane(_scores(tp, ft), want)


def test_two_layers_through_ml_disc_init_match_jax_vmap(rng):
    """Two layers of three objects each, one disc_init per layer: the
    scores of every layer and lane within 1e-5 of their peak (measured
    6.2e-7 and 1.1e-6)."""
    shapes = {"layer4": (6, 8, 16), "layer3": (12, 16, 8)}
    kw = dict(c_channels=8, init_iters=(2, 3), update_iters=(3,), memory_size=6,
              train_skipping=1)
    jcfgs = {L: jd.DiscConfig(in_channels=c, layer=L, **kw) for L, (_, _, c) in shapes.items()}
    tcfgs = {L: DiscConfig(in_channels=c, layer=L, **kw) for L, (_, _, c) in shapes.items()}
    K, H, W = 3, 48, 64
    feats = {L: rng.randn(N, K, h, w, c).astype(np.float32) * 0.3
             for L, (h, w, c) in shapes.items()}
    masks = np.zeros((N, K, H, W, 1), np.float32)
    for i in range(N):
        masks[i, :, 10 + 3 * i:34, 14:44 - 4 * i] = 1
    p0 = jml.ml_init_params(jax.random.PRNGKey(0), jcfgs)
    jp, js = jax.vmap(lambda f, m: jml.ml_disc_init(p0, f, m, jcfgs))(
        {L: jnp.asarray(f) for L, f in feats.items()}, jnp.asarray(masks))
    tp0 = {L: td.repeat_params(disc_params_from_jax(np.asarray(p.project),
                                                    np.asarray(p.filter)), N)
           for L, p in p0.items()}
    tp, ts = tml.ml_disc_init(tp0, {L: t5(f) for L, f in feats.items()}, t5(masks), tcfgs)
    assert list(tp) == list(ts) == ["layer3", "layer4"]
    for L, (h, w, c) in shapes.items():
        ft = rng.randn(2, h, w, c).astype(np.float32) * 0.3
        _close_per_lane(_scores(tp[L], ft), _jax_scores(jp[L], ft))
        assert ts[L].memory.weights.shape == (N, kw["memory_size"])


@pytest.mark.parametrize("solver", ["stencil", "residual"])
def test_one_lane_equals_the_per_object_solve(rng, solver):
    """Each lane of a three-object disc_init against the one-object
    (N = 1) solve of the same object, and that one-object solve against
    frtm_tpu's per-object disc_init (unbatched): filters and projections
    within 1e-5 of their peak. Measured: lanes against one-object solves
    0 (equal bits); the one-object solve against frtm_tpu 4.5e-7 to 8.5e-7,
    of the order of frtm_tpu's own movement under a 1e-6 nudge of its
    features, which the test measures too."""
    jcfg, tcfg = jd.DiscConfig(**CFG, solver=solver), DiscConfig(**CFG, solver=solver)
    p0, tp0 = _p0(jcfg)
    feats, labels = _problem(rng)
    tp, _ = td.disc_init(td.repeat_params(tp0, N), t5(feats), t5(labels), tcfg)
    nudge = []
    for i in range(N):
        one, _ = td.disc_init(td.repeat_params(tp0, 1), t5(feats[i:i + 1]),
                              t5(labels[i:i + 1]), tcfg)
        _close_per_lane(tp.filter[i:i + 1].numpy(), one.filter.numpy())
        _close_per_lane(tp.project[i:i + 1].numpy(), one.project.numpy())
        jp, _ = jd.disc_init(p0, jnp.asarray(feats[i]), jnp.asarray(labels[i]), jcfg)
        _close_per_lane(one.filter.numpy(), oihw(jp.filter[None]))
        jn, _ = jd.disc_init(p0, jnp.asarray(feats[i] * (1 + 1e-6)), jnp.asarray(labels[i]), jcfg)
        want = oihw(jp.filter[None])
        nudge.append(float(np.abs(oihw(jn.filter[None]) - want).max() / np.abs(want).max()))
    # the yardstick: frtm_tpu's own sensitivity is of the bound's order or below
    assert 1e-8 < max(nudge) < TOL, nudge


HEAVY_OPS = ("aten::convolution", "aten::bmm")


def _count_heavy_ops(fn):
    """The calls of each op in HEAVY_OPS that fn makes (torch.profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [ev.name for ev in prof.events()]
    return {op: names.count(op) for op in HEAVY_OPS}


def test_convolutions_of_one_init_do_not_grow_with_objects(rng):
    """One init of 1 and of 3 objects makes the same number of calls of
    aten::convolution and of aten::bmm, which takes the lanes' own weights
    (torch.profiler): in disc_init alone (47 and 124 on the CPU), and in the
    fused tracker's init with its backbone pass over all objects' augmented
    frames. A loop over objects would triple them."""
    tcfg = DiscConfig(**CFG)
    _, tp0 = _p0(jd.DiscConfig(**CFG))
    counts = {}
    for n in (1, N):
        feats, labels = _problem(np.random.RandomState(0), n=n)
        counts[n] = _count_heavy_ops(
            lambda: td.disc_init(td.repeat_params(tp0, n), t5(feats), t5(labels), tcfg))
    assert counts[1] == counts[N], counts
    assert counts[1]["aten::convolution"] > 0 and counts[1]["aten::bmm"] > 0, counts

    cfg = eval_config("resnet18", fast=True, num_aug=3)
    cfg = replace(cfg, disc=replace(cfg.disc, c_channels=16, init_iters=(3, 5),
                                    update_iters=(3,), memory_size=8))
    ch = {L: c for L, c in resnet_out_channels("resnet18").items() if L in cfg.refnet_layers}
    tracker = BatchedSequenceTracker(
        cfg, init_resnet("resnet18", torch.Generator().manual_seed(1), device="cpu"),
        init_seg_network(ch, torch.Generator().manual_seed(2), device="cpu"), device="cpu")
    K, H, W = 4, 48, 64
    counts = {}
    for n in (1, N):
        images = torch.from_numpy(rng.randint(0, 255, (n, K, 3, H, W)).astype(np.uint8))
        labels = torch.zeros((n, K, 1, H, W), dtype=torch.uint8)
        labels[..., 12:30, 20:44] = 1
        with torch.no_grad():
            counts[n] = _count_heavy_ops(lambda: tracker._init_objects_dense(images, labels))
    assert counts[1] == counts[N], counts
    assert counts[1]["aten::convolution"] > 0 and counts[1]["aten::bmm"] > 0, counts


def test_cold_start_on_three_misses_matches_jax(weights):
    """The trainer's cold start with three distinct misses (one disc_init of
    three lanes) against frtm_tpu's `_init_disc_batch` (a jax.vmap of
    disc_init) on the same three samples, each side augmenting and
    extracting its own: filters and projections within 1e-2 of their peak,
    the bound test_torch_trainer.py holds the cold start to (the two
    backbones' features differ in their last bits, and this init is
    ill-conditioned, F5); measured 4.2e-3 (filters) and 4.7e-4
    (projections)."""
    images, labels, enc = batch(3, (64, 96))
    tm = port_model(weights, TModelCache(None, enable=False))
    tdisc, hits = tm.build_disc_batch(images[0], labels[0], SampleSpec.from_encoded(enc))
    assert hits == 0
    jm_ = jax_model(weights)
    ims, lbs = [], []
    for i in range(3):
        im, lb = jm_.augmenter.augment_first_frame(images[0][i], labels[0][i],
                                                   np.random.RandomState(0))
        ims.append(np.asarray(im, np.uint8))
        lbs.append(np.asarray(lb, np.uint8))
    K = ims[0].shape[0]
    ft = jm_._extract_flat(np.concatenate(ims))
    ft = ft.reshape((3, K) + ft.shape[1:])
    jp, _ = jm_._init_disc_batch(jm_._disc_params0, ft, jnp.asarray(np.stack(lbs)))
    _close_per_lane(tdisc.filter.numpy(), oihw(jp.filter), 1e-2)
    _close_per_lane(tdisc.project.numpy(), oihw(jp.project), 1e-2)


@pytest.fixture(scope="module")
def world():
    from test_torch_sequence_tracker import World
    return World()


def test_fused_tracker_three_objects_one_entering_matches_jax(world):
    """Three objects, the third entering at frame 3 (not a window boundary:
    the per-frame loop, in which the lanes are due on different frames),
    against frtm_tpu's fused tracker behind FreshBatches, both in the
    deferred merge. The soft volumes are held to frtm_tpu's own movement
    when its input features move by 1e-6 (the stem convolution scaled),
    measured here: the port's gap measured 8.6e-3 at most over the frames,
    frtm_tpu's own movement 5.4e-2. Labels merged from the volumes likewise:
    the port's differ from frtm_tpu's on at most 0.49 % of a frame, the
    nudge moves frtm_tpu's own by up to 6.3 %. (With three objects and
    random weights both trackers drop objects in some frames and the init
    is ill-conditioned; the two-object fixture of
    test_torch_sequence_tracker.py holds the port to 1e-3 at 9.6e-5.) Every
    object holds soft foreground in its tracked frames; the lanes of objects 1 and 2 tracked
    6 frames, object 3's 3, each lane re-solved on its own frames (measured
    1, 2 and 1 re-solves)."""
    from test_torch_sequence_tracker import JaxFused, _sequence
    from frtm_tpu_torch.runtime.sequence_tracker import merge_volume
    seq = _sequence(7, 3, starts={"00000": [1, 2], "00003": [3]}, seed=10)
    want = world.jax("deferred").run_sequence(seq, soft=True)[0]
    port = world.port("deferred")
    got = port.run_sequence(seq, soft=True)[0]
    backbone = dict(world.backbone)
    backbone["conv1"] = world.backbone["conv1"] * (1 + 1e-6)
    moved = JaxFused(world.jcfg, backbone, world.refiner, extract_chunk=4, scan_bucket=8,
                     merge_mode="deferred")
    moved.augmenter = FreshBatches(moved.augmenter)
    nudged = moved.run_sequence(seq, soft=True)[0]
    assert got.shape == want.shape == (7, 3) + SIZE
    gap, own = float(np.abs(got - want).max()), float(np.abs(nudged - want).max())
    assert gap <= own, (gap, own)
    lut = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    got_lb, want_lb, nudged_lb = (merge_volume(torch.from_numpy(np.array(v)), lut).numpy()
                                  for v in (got, want, nudged))
    gap = max(float(np.mean(a != b)) for a, b in zip(got_lb, want_lb))
    own = max(float(np.mean(a != b)) for a, b in zip(nudged_lb, want_lb))
    assert gap <= own, (gap, own)
    for k, start in enumerate((0, 0, 3)):
        assert all((got[t, k] > 0.5).sum() >= 10 for t in range(start + 1, 7)), k
    _, state = port.last_models
    assert state.frame_num == [6, 6, 3]
    # object 3's one re-solve falls on frame 5, where objects 1 and 2 are not
    # due; theirs fall on frames 2, 4 and 6 where their masks hold >= 10 px
    assert state.n_resolves.tolist() == [1, 2, 1]
