"""The target model's legacy modes in the port against frtm_tpu on the same
inputs and starting weights: every pixel-weighting method (global and per
frame, with distractors, NaN quirk included), every online update method,
clamped scores, the direct residual solver, and the solvers' loss
trajectories in both forms.

Tolerances: pixel and update weights are elementwise float32 arithmetic in
the same order (rtol 1e-6); solves are compared through their scores, not
their filters, because the phase-1 problem is ill-conditioned at these
sizes (ROADMAP.md section 4, F5): scores within 1e-3 of their peak, loss
trajectories within rtol 1e-3. The direct solver calls solve a problem
linear in its parameters: parameters within 1e-4 of their peak, losses
within rtol 1e-4.

The port's functions take an object axis; these tests give them one
object (N = 1), as the host loop does, and read its lane."""
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.models import discriminator as jd
from frtm_tpu.models import lsq_stencil as jls
from frtm_tpu.models import solver as jsolver
from frtm_tpu_torch.config import DiscConfig
from frtm_tpu_torch.models import discriminator as td
from frtm_tpu_torch.models import lsq_stencil as tls
from frtm_tpu_torch.models import solver as tsolver
from frtm_tpu_torch.utils.convert import disc_params_from_jax

CFG = dict(in_channels=32, c_channels=8, init_iters=(3, 5), update_iters=(3,),
           memory_size=8, train_skipping=2)


def t(a):
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def n(x):
    """NCHW tensor -> NHWC numpy."""
    return np.moveaxis(x.numpy(), 1, -1)


def _labels(rng, N=3, H=16, W=20):
    """Soft masks with one object per frame, a distractor (label 2) beside it
    in two frames, and one frame with a tiny object (under 10 px)."""
    y = np.zeros((N, H, W, 1), np.float32)
    for k in range(N):
        y[k, 2 + k:11 + k, 3:12 + 2 * k] = 1.0
    y[0, 12:15, 14:19] = 2.0
    y[1, 1:3, 15:20] = 2.0
    y[2] = 0.0
    y[2, 5:7, 5:8] = 1.0
    return y


@pytest.mark.parametrize("distractor_mult", [1.0, 3.0])
@pytest.mark.parametrize("per_frame", [True, False])
@pytest.mark.parametrize("method", ["none", "fixed", "hinge", "first-frame"])
def test_pixel_weights_match_jax(rng, method, per_frame, distractor_mult):
    kw = dict(CFG, pixel_weighting_method=method, pixel_weighting_per_frame=per_frame,
              distractor_mult=distractor_mult)
    y = _labels(rng)
    want = np.asarray(jd.compute_pixel_weights(jnp.asarray(y), jd.DiscConfig(**kw)))
    got = n(td.compute_pixel_weights(t(y), DiscConfig(**kw)))
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_distractor_nan_quirk_is_kept():
    """A large object with a distractor under the 'fixed' weighting: 2 wf -
    wb < 0, so sqrt gives NaN in both packages, as in the reference."""
    y = np.zeros((1, 8, 8, 1), np.float32)
    y[0, :4] = 1.0
    y[0, 4:6] = 2.0
    kw = dict(CFG, pixel_weighting_method="fixed")
    got = n(td.compute_pixel_weights(t(y), DiscConfig(**kw)))
    want = np.asarray(jd.compute_pixel_weights(jnp.asarray(y), jd.DiscConfig(**kw)))
    assert np.isnan(got[0, 4:6]).all() and np.isnan(want[0, 4:6]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


METHODS = ["frtm", "thresh", "conf", "raw", "raw-conf"]


@pytest.mark.parametrize("method", METHODS)
def test_online_update_weights_match_jax(rng, method):
    y = (rng.rand(16, 20, 1) * (rng.rand(16, 20, 1) > 0.4)).astype(np.float32)
    want_y, want_w = jd.online_update_weights(jnp.asarray(y), jd.DiscConfig(**CFG, update_method=method))
    got_y, got_w = td.online_update_weights(t(y[None])[0], DiscConfig(**CFG, update_method=method))
    np.testing.assert_allclose(n(got_y[None])[0], np.asarray(want_y), rtol=1e-6)
    np.testing.assert_allclose(n(got_w[None])[0], np.asarray(want_w), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        td.online_update_weights(t(y[None])[0], DiscConfig(update_method="other"))


def _problem(rng, K=3, h=6, w=8, stride=4):
    feats = rng.randn(K, h, w, CFG["in_channels"]).astype(np.float32)
    labels = np.zeros((K, h * stride, w * stride, 1), np.float32)
    for k in range(K):
        y, x = rng.randint(0, h * stride - 10), rng.randint(0, w * stride - 10)
        labels[k, y:y + 9, x:x + 11] = 1.0
    return feats, labels


def _init_both(rng, collect_losses=False, **kw):
    jcfg, tcfg = jd.DiscConfig(**CFG, **kw), DiscConfig(**CFG, **kw)
    p0 = jd.init_disc_params(jax.random.PRNGKey(0), jcfg)
    feats, labels = _problem(rng)
    jout = jd.disc_init(p0, jnp.asarray(feats), jnp.asarray(labels), jcfg,
                        collect_losses=collect_losses)
    tout = td.disc_init(td.repeat_params(disc_params_from_jax(np.asarray(p0.project),
                                                              np.asarray(p0.filter)), 1),
                        t(feats)[None], t(labels)[None], tcfg, collect_losses=collect_losses)
    return (jcfg,) + tuple(jout), (tcfg,) + tuple(tout)


def _scores_close(tp, jp, ft, tol=1e-3, clamp=False):
    js, _ = jd.disc_apply(jp, jnp.asarray(ft), clamp_output=clamp)
    ts, _ = td.disc_apply(tp, t(ft), clamp_output=clamp)
    js = np.asarray(js)
    np.testing.assert_allclose(n(ts), js, rtol=0, atol=tol * float(np.abs(js).max()))
    return n(ts)


@pytest.mark.parametrize("method", METHODS)
def test_update_methods_through_disc_update_match_jax(rng, method):
    """Two updates and a re-solve per method: the stored labels and pixel
    weights equal JAX's, the scores within 1e-3 of their peak."""
    (jcfg, jp, js), (tcfg, tp, ts) = _init_both(rng, update_method=method)
    for frame in (1, 2):
        ft = rng.randn(1, 6, 8, CFG["in_channels"]).astype(np.float32)
        y = np.zeros((24, 32, 1), np.float32)
        y[4 + frame:15 + frame, 6:18] = rng.rand(11, 12, 1)
        _, jcft = jd.disc_apply(jp, jnp.asarray(ft))
        _, tcft = td.disc_apply(tp, t(ft))
        jp, js = jd.disc_update(jp, js, jcft[0], jnp.asarray(y), jcfg)
        tp, ts = td.disc_update(tp, ts, tcft[0], t(y[None]), tcfg)
        np.testing.assert_allclose(n(ts.memory.labels[0]), np.asarray(js.memory.labels),
                                   rtol=1e-6)
        np.testing.assert_allclose(n(ts.memory.pixel_weights[0]),
                                   np.asarray(js.memory.pixel_weights), rtol=1e-6, atol=1e-7)
    assert ts.n_resolves.tolist() == [1]
    _scores_close(tp, jp, rng.randn(1, 6, 8, CFG["in_channels"]).astype(np.float32))


def test_clamp_output_matches_jax(rng):
    (jcfg, jp, js), (tcfg, tp, ts) = _init_both(rng)
    ft = rng.randn(2, 6, 8, CFG["in_channels"]).astype(np.float32) * 4
    got = _scores_close(tp, jp, ft, clamp=True)
    assert got.min() == np.float32(-0.1) and got.max() == np.float32(1.2)
    # the fused tracker's grouped classification clamps alike
    cft = td.disc_apply(tp, t(ft))[1]
    grouped = td.classify_objects(cft, tp.filter, clamp_output=True)
    np.testing.assert_array_equal(grouped[:, 0].numpy(), got[..., 0])


def test_residual_solver_matches_jax(rng):
    """The direct residual form against frtm_tpu's residual form, and
    against the port's own stencil form (the same least-squares problem)."""
    (jcfg, jp, js), (tcfg, tp, ts) = _init_both(rng, solver="residual")
    ft = rng.randn(2, 6, 8, CFG["in_channels"]).astype(np.float32)
    got = _scores_close(tp, jp, ft)
    rng2 = np.random.RandomState(0)
    (_, jp_s, _), (_, tp_s, _) = _init_both(rng2, solver="stencil")
    stencil = n(td.disc_apply(tp_s, t(ft))[0])
    np.testing.assert_allclose(got, stencil, rtol=0, atol=1e-3 * np.abs(stencil).max())


@pytest.mark.parametrize("solver", ["stencil", "residual"])
def test_collect_losses_trajectories_match_jax(rng, solver):
    (jcfg, jp, js, jl), (tcfg, tp, ts, tloss) = _init_both(rng, collect_losses=True,
                                                            solver=solver)
    for key, n_iter in (("init", len(CFG["init_iters"])), ("update", len(CFG["update_iters"]))):
        got, want = tloss[key][0].numpy(), np.asarray(jl[key])
        assert got.shape == (n_iter + 1,)
        np.testing.assert_allclose(got, want, rtol=1e-3)
        assert got[-1] < got[0]
    # the re-solve reports its trajectory too
    jout = jd.filter_resolve(jp, js, jcfg, collect_losses=True)
    tout = td.filter_resolve(tp, ts, tcfg, collect_losses=True)
    np.testing.assert_allclose(tout[2][0].numpy(), np.asarray(jout[2]), rtol=1e-3)


def test_both_forms_report_the_same_losses(rng):
    """The stencil form's quadratic identity gives the residual form's
    squared norms (one problem, two forms)."""
    feats, labels = _problem(rng)
    p0 = jd.init_disc_params(jax.random.PRNGKey(0), jd.DiscConfig(**CFG))
    out = {}
    for solver in ("stencil", "residual"):
        out[solver] = td.disc_init(td.repeat_params(disc_params_from_jax(
                                       np.asarray(p0.project), np.asarray(p0.filter)), 1),
                                   t(feats)[None], t(labels)[None],
                                   DiscConfig(**CFG, solver=solver), collect_losses=True)[2]
    for key in ("init", "update"):
        np.testing.assert_allclose(out["stencil"][key].numpy(), out["residual"][key].numpy(),
                                   rtol=1e-3)


def test_update_filters_off_only_counts_frames(rng):
    (jcfg, jp, js), (tcfg, tp, ts) = _init_both(rng, update_filters=False)
    before = tp.filter.clone()
    y = np.ones((24, 32, 1), np.float32)
    _, tcft = td.disc_apply(tp, t(rng.randn(1, 6, 8, CFG["in_channels"]).astype(np.float32)))
    for _ in range(2):
        tp, ts = td.disc_update(tp, ts, tcft[0], t(y[None]), tcfg)
    assert ts.frame_num == [2] and ts.n_resolves.tolist() == [0]
    assert torch.equal(tp.filter, before)
    assert int(ts.memory.current_size) == 3


def _solve_both(rng, form, fletcher_reeves):
    """One weighted least-squares problem, linear in a (C,) filter f with
    scores einsum(x, f) at (h, w), through frtm_tpu's and the port's solver
    of the given form: ((theta, rho, losses) of JAX, of the port). The
    port's solver takes the problem as one lane (N = 1)."""
    S, C, h, w = 3, 24, 5, 7
    H, W = (h, w) if form == "residual" else (4 * h, 4 * w)
    x = rng.randn(S, C, h, w).astype(np.float32)
    y = (rng.rand(S, H, W) > 0.5).astype(np.float32)
    w2 = (0.5 + rng.rand(S, H, W)).astype(np.float32)
    f0 = (0.1 * rng.randn(C)).astype(np.float32)
    reg, precond, schedule, dff = 0.1, 2.0, (3, 2, 2), 5.0
    kw = dict(fletcher_reeves=fletcher_reeves, collect_losses=True)
    out = []
    for xp, solver, stencil, arr, M1 in (
            (jnp, jsolver, jls, jnp.asarray,
             jsolver.scalar_preconditioner((jnp.asarray(precond, jnp.float32),))),
            (torch, tsolver, tls, torch.from_numpy, tsolver.scalar_preconditioner((precond,)))):
        lane = (lambda a: a[None]) if xp is torch else (lambda a: a)
        xa, ya, w2a, theta = arr(x), lane(arr(y)), lane(arr(w2)), (lane(arr(f0)),)

        def net(f, xp=xp, xa=xa):
            return xp.einsum("schw,...c->...shw", xa, f)

        state = solver.init_cg_state(theta)
        if xp is jnp:
            unpack = lambda fn: (lambda th: fn(*th))       # JAX solvers take the pytree
        else:
            unpack = lambda fn: fn
        if form == "residual":
            def residuals(f, xp=xp, net=net, ya=ya, w2a=w2a):
                return (xp.sqrt(w2a) * (net(f) - ya), reg * f)
            theta, state, losses = solver.gauss_newton_cg(unpack(residuals), theta, state,
                                                          schedule, M1, dff, **kw)
        else:
            M9 = lane(stencil.precompute_stencil(arr(w2), (h, w)))
            v = lane(stencil.project_targets(arr(w2), arr(y), (h, w)))
            const = float((w2 * y * y).sum())
            theta, state, losses = solver.gauss_newton_cg_quadform(
                unpack(net), theta, state, schedule, M1, dff, M9, v, (reg,),
                loss_const=const, **kw)
        if xp is torch:     # the lane
            theta, rho, losses = (theta[0][0],), state.rho[0], losses[0]
        else:
            rho = state.rho
        out.append((np.asarray(theta[0]), float(rho), np.asarray(losses)))
    return out


@pytest.mark.parametrize("fletcher_reeves", [False, True])
@pytest.mark.parametrize("form", ["residual", "quadform"])
def test_gauss_newton_cg_matches_jax(form, fletcher_reeves):
    """Both solver forms with either CG beta against frtm_tpu's solvers
    (whose discriminator always passes fletcher_reeves=False, so they are
    called directly): the filter, the last rho and the loss trajectory.
    Warm-started over three GN iterations the two betas differ, so the
    Fletcher-Reeves case must also move the filter away from the
    Polak-Ribiere one."""
    (jf, jrho, jloss), (tf, trho, tloss) = _solve_both(np.random.RandomState(3), form,
                                                       fletcher_reeves)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-4 * np.abs(jf).max())
    np.testing.assert_allclose(trho, jrho, rtol=1e-4)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert tloss.shape == (4,) and tloss[-1] < tloss[0]
    if fletcher_reeves:
        (_, _, _), (pr, _, _) = _solve_both(np.random.RandomState(3), form, False)
        assert np.abs(tf - pr).max() > 1e-3 * np.abs(pr).max(), np.abs(tf - pr).max()
