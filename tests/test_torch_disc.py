"""The port's target model — memory, stencil, GN-CG init and the online
update — against frtm_tpu's on the same inputs and starting weights. The
port's functions take an object axis; these tests give them one object
(N = 1), as the host loop does, and read its lane."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.models import discriminator as jd
from frtm_tpu.models import lsq_stencil as jl
from frtm_tpu.models import memory as jm
from frtm_tpu_torch.config import DiscConfig
from frtm_tpu_torch.models import discriminator as td
from frtm_tpu_torch.models import lsq_stencil as tl
from frtm_tpu_torch.models import memory as tm
from frtm_tpu_torch.utils.convert import disc_params_from_jax

CFG = dict(in_channels=32, c_channels=8, init_iters=(3, 5), update_iters=(3,),
           memory_size=8, train_skipping=2)


def t(a):
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def n(x):
    """NCHW tensor -> NHWC numpy."""
    return np.moveaxis(x.numpy(), 1, -1)


def _problem(rng, K=3, h=6, w=8, stride=4):
    feats = rng.randn(K, h, w, CFG["in_channels"]).astype(np.float32)
    labels = np.zeros((K, h * stride, w * stride, 1), np.float32)
    for k in range(K):
        y, x = rng.randint(0, h * stride - 10), rng.randint(0, w * stride - 10)
        labels[k, y:y + 9, x:x + 11] = 1.0
    return feats, labels


def test_memory_insert_and_replace_match_jax(rng):
    feats = rng.randn(3, 4, 5, 6).astype(np.float32)
    labels = (rng.rand(3, 8, 10, 1) > 0.5).astype(np.float32)
    pw = rng.rand(3, 8, 10, 1).astype(np.float32)
    js = jm.memory_init(5, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(pw))
    ts = tm.memory_init(5, t(feats)[None], t(labels)[None], t(pw)[None])
    for step, enabled in enumerate([True, True, False, True, True, True]):
        f = rng.randn(4, 5, 6).astype(np.float32)
        y = rng.rand(8, 10, 1).astype(np.float32)
        p = rng.rand(8, 10, 1).astype(np.float32)
        js = jm.memory_update(js, jnp.asarray(f), jnp.asarray(y), jnp.asarray(p), 0.1,
                              enabled=jnp.asarray(enabled))
        ts = tm.memory_update(ts, t(f[None]), t(y[None]), t(p[None]), 0.1, enabled=enabled)
        np.testing.assert_allclose(ts.weights[0].numpy(), np.asarray(js.weights), rtol=1e-6)
        assert ts.current_size.tolist() == [int(js.current_size)]
        assert ts.prev_ind.tolist() == [int(js.prev_ind)]
        np.testing.assert_array_equal(n(ts.samples[0]), np.asarray(js.samples))
        np.testing.assert_array_equal(n(ts.labels[0]), np.asarray(js.labels))
        np.testing.assert_array_equal(n(ts.pixel_weights[0]), np.asarray(js.pixel_weights))


def test_stencil_matches_jax(rng):
    w2 = rng.rand(3, 24, 32).astype(np.float32)
    y = rng.rand(3, 24, 32).astype(np.float32)
    s = rng.randn(3, 6, 8).astype(np.float32)
    jM9 = jl.precompute_stencil(jnp.asarray(w2), (6, 8))
    tM9 = tl.precompute_stencil(torch.from_numpy(w2), (6, 8))
    # measured max abs diff 2.4e-7
    np.testing.assert_allclose(tM9.numpy(), np.asarray(jM9), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.project_targets(torch.from_numpy(w2), torch.from_numpy(y),
                                                  (6, 8)).numpy(),
                               np.asarray(jl.project_targets(jnp.asarray(w2), jnp.asarray(y),
                                                             (6, 8))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.apply_stencil(tM9, torch.from_numpy(s)).numpy(),
                               np.asarray(jl.apply_stencil(jM9, jnp.asarray(s))),
                               rtol=1e-5, atol=1e-5)


def _init_both(rng):
    jcfg = jd.DiscConfig(**CFG)
    tcfg = DiscConfig(**CFG)
    p0 = jd.init_disc_params(jax.random.PRNGKey(0), jcfg)
    feats, labels = _problem(rng)
    jp, js = jd.disc_init(p0, jnp.asarray(feats), jnp.asarray(labels), jcfg)
    tp, ts = td.disc_init(td.repeat_params(disc_params_from_jax(np.asarray(p0.project),
                                                                np.asarray(p0.filter)), 1),
                          t(feats)[None], t(labels)[None], tcfg)
    return (jcfg, jp, js), (tcfg, tp, ts)


def _filters_close(tp, jp, rtol=1e-3):
    for a, b in ((tp.project[0], jp.project), (tp.filter[0], jp.filter)):
        b = np.transpose(np.asarray(b), (3, 2, 0, 1))
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=rtol * np.abs(b).max())


def test_disc_init_both_phases_match_jax(rng):
    (jcfg, jp, js), (tcfg, tp, ts) = _init_both(rng)
    # phase 1 sets `project`, phase 2 re-solves `filter` from the big memory;
    # measured max relative-to-peak diff 2e-5
    _filters_close(tp, jp)
    np.testing.assert_allclose(ts.memory.weights[0].numpy(), np.asarray(js.memory.weights),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ts.cg.rho[0]), float(js.cg.rho), rtol=1e-3)


def test_disc_update_across_a_resolve_matches_jax(rng):
    (jcfg, jp, js), (tcfg, tp, ts) = _init_both(rng)
    for frame in range(1, 5):        # train_skipping=2: re-solves at frames 2 and 4
        ft = rng.randn(1, 6, 8, CFG["in_channels"]).astype(np.float32)
        y = np.zeros((24, 32, 1), np.float32)
        y[4 + frame:15 + frame, 6:18] = rng.rand(11, 12, 1) * 0.5 + 0.5
        jscores, jcft = jd.disc_apply(jp, jnp.asarray(ft))
        tscores, tcft = td.disc_apply(tp, t(ft))
        np.testing.assert_allclose(n(tscores), np.asarray(jscores), rtol=1e-3,
                                   atol=1e-3 * float(np.abs(np.asarray(jscores)).max()))
        jp, js = jd.disc_update(jp, js, jcft[0], jnp.asarray(y), jcfg)
        tp, ts = td.disc_update(tp, ts, tcft[0], t(y[None]), tcfg)
        assert ts.frame_num == [int(js.frame_num)]
        _filters_close(tp, jp)
    assert ts.n_resolves.tolist() == [2]


@pytest.mark.parametrize("area", [0, 5, 200])
def test_hinge_pixel_weights_match_jax(rng, area):
    y = np.zeros((2, 16, 20, 1), np.float32)
    y[:, :1, :area // 1 if area < 20 else 20] = 1.0
    if area == 200:
        y[:, :10] = 1.0
    want = np.asarray(jd.compute_pixel_weights(jnp.asarray(y), jd.DiscConfig(**CFG)))
    got = n(td.compute_pixel_weights(t(y), DiscConfig(**CFG)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
