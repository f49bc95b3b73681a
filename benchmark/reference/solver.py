"""Gauss-Newton / conjugate-gradient least-squares solver
(frtm_tpu/models/solver.py), on tuples of tensors.

One Gauss-Newton linearisation per entry of the CG schedule; preconditioned
CG with Polak-Ribiere (or Fletcher-Reeves) beta clamped at 0, warm-started
direction state with a forgetting factor, the step_alpha ramp, and inner
products summed over all parameter blocks. JAX's `linearize` /
`linear_transpose` become `torch.func.jvp` / `torch.func.vjp`, re-linearised
at every GN iteration (phase 1's conv(conv(x, project), filter) is bilinear,
so the linearisation point matters).

N independent problems are solved together, as the JAX package's `jax.vmap`
over objects solves them: every block of theta and of the residuals carries
a leading lane axis, no operator couples two lanes, and the inner products,
rho, beta, alpha, have_p, step_alpha and the losses are (N,) vectors, one
entry per lane, broadcast over each block. The preconditioner keeps one
scalar per block, shared by the lanes.

Two forms of the same problem: `gauss_newton_cg` on a residual function
(the direct form) and `gauss_newton_cg_quadform` on the quadratic form with
the label-space curvature as a score-space stencil (the eval path). Both can
report the squared residual norm before every GN iteration and after the
last (`collect_losses`), the stencil form through the quadratic identity.
"""
from dataclasses import dataclass, replace
from typing import Tuple

import torch
from torch.func import jvp, vjp

from .lsq_stencil import apply_stencil


def lane_dot(x, y) -> torch.Tensor:
    """Per-lane inner product of two (N, ...) tensors: (N,)."""
    return (x * y).reshape(x.shape[0], -1).sum(dim=1)


def tree_vdot(a, b) -> torch.Tensor:
    """Per-lane inner product over all blocks: (N,)."""
    return torch.stack([lane_dot(x, y) for x, y in zip(a, b)]).sum(dim=0)


def lanes(v, x):
    """The (N,) vector v shaped to broadcast over the (N, ...) tensor x."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def _axpy(a, x, y):
    return tuple(yi + lanes(a, xi) * xi for xi, yi in zip(x, y))


@dataclass
class CGState:
    """Warm-startable CG direction state of N lanes."""
    p: Tuple[torch.Tensor, ...]       # theta-like, (N, ...) blocks
    r_prev: Tuple[torch.Tensor, ...]
    rho: torch.Tensor                 # (N,)
    have_p: torch.Tensor              # (N,) bool
    step_alpha: torch.Tensor          # (N,)


def init_cg_state(theta_like, step_alpha: float = 1.0) -> CGState:
    dev, n = theta_like[0].device, theta_like[0].shape[0]
    return CGState(
        p=tuple(torch.zeros_like(t) for t in theta_like),
        r_prev=tuple(torch.zeros_like(t) for t in theta_like),
        rho=torch.ones(n, device=dev),
        have_p=torch.zeros(n, dtype=torch.bool, device=dev),
        step_alpha=torch.full((n,), step_alpha, dtype=torch.float32, device=dev),
    )


def _run_cg(A, b, state: CGState, n_iter: int, M1, direction_forget_factor,
            fletcher_reeves: bool = False):
    """One preconditioned CG solve of A x = b (Polak-Ribiere, or
    Fletcher-Reeves) per lane, warm-started from `state`; the last
    iteration skips the residual update."""
    if direction_forget_factor == 0:
        state = replace(state, p=tuple(torch.zeros_like(t) for t in b),
                        r_prev=tuple(torch.zeros_like(t) for t in b),
                        rho=torch.ones_like(state.rho),
                        have_p=torch.zeros_like(state.have_p))
        rho = state.rho
    else:
        rho = torch.where(state.have_p, state.rho / direction_forget_factor, state.rho)

    x = tuple(torch.zeros_like(t) for t in b)
    r, p, r_prev, have_p = b, state.p, state.r_prev, state.have_p
    for ii in range(n_iter):
        z = M1(r)
        rho1 = rho
        rho = tree_vdot(r, z)
        num = rho if fletcher_reeves else rho - tree_vdot(r_prev, z)
        nonzero = rho1 != 0.0
        beta = torch.where(nonzero, num / torch.where(nonzero, rho1, torch.ones_like(rho1)),
                           torch.zeros_like(rho1))
        beta = torch.clamp_min(beta, 0.0)
        use_beta = torch.where(have_p, beta, torch.zeros_like(beta))
        p = tuple(zi + lanes(use_beta, zi) * pi for zi, pi in zip(z, p))
        q = A(p)
        pq = tree_vdot(p, q)
        alpha = torch.where(pq != 0.0, rho / pq, torch.zeros_like(pq))
        if not fletcher_reeves:
            r_prev = r
        x = _axpy(alpha, p, x)
        if ii < n_iter - 1:
            r = _axpy(-alpha, q, r)
        have_p = torch.ones_like(have_p)
    return x, replace(state, p=p, r_prev=r_prev, rho=rho, have_p=have_p)


def _sum_squares(blocks) -> torch.Tensor:
    return tree_vdot(blocks, blocks)


def gauss_newton_cg(residual_fn, theta, state: CGState, num_cg_iter, M1,
                    direction_forget_factor: float, fletcher_reeves: bool = False,
                    collect_losses: bool = False):
    """len(num_cg_iter) Gauss-Newton iterations on a residual function, each
    with the given number of CG steps; the CG operator is J'(J p).

    :param residual_fn: (*theta) -> tuple of (N, ...) residual tensors
    :return: (theta, CGState[, losses (N, len(num_cg_iter) + 1)])
    """
    theta = tuple(theta)
    losses = []
    for n_cg in num_cg_iter:
        f0, vjp_fn = vjp(residual_fn, *theta)
        if collect_losses:
            losses.append(_sum_squares(f0))

        def A(p, theta=theta, vjp_fn=vjp_fn):
            _, jp = jvp(residual_fn, theta, tuple(p))
            return vjp_fn(jp)

        b = tuple(-g for g in vjp_fn(f0))
        dx, state = _run_cg(A, b, state, n_cg, M1, direction_forget_factor, fletcher_reeves)
        theta = _axpy(state.step_alpha, dx, theta)
        state = replace(state, step_alpha=torch.clamp_max(state.step_alpha * 1.2, 1.0))
    if collect_losses:
        losses.append(_sum_squares(residual_fn(*theta)))
        return theta, state, torch.stack(losses, dim=1)
    return theta, state


def gauss_newton_cg_quadform(net_fn, theta, state: CGState, num_cg_iter, M1,
                             direction_forget_factor: float, M9, v, regs,
                             fletcher_reeves: bool = False, collect_losses: bool = False,
                             loss_const=0.0):
    """GN-CG on ||W(U net(theta) - y)||^2 + sum ||reg_i theta_i||^2 with the
    label-space curvature as the precomputed score-space stencil M9 and the
    projected targets v (models/lsq_stencil.py).

    :param net_fn: (*theta) -> (N, S, h, w) score maps
    :param M9: (N, S, 3, 3, h, w) stencil maps; v: (N, S, h, w)
    :param collect_losses: also return the squared residual norms the
        residual form reports, as s'Ms - 2 s'v + loss_const + sum reg_i^2
        ||theta_i||^2, per lane: (N, len(num_cg_iter) + 1)
    :param loss_const: the data term's constant y'diag(w^2)y, (N,) (used
        only with collect_losses)
    """
    reg2 = [r * r for r in regs]
    theta = tuple(theta)
    losses = []

    def loss(s, th):
        data = lane_dot(s, apply_stencil(M9, s)) - 2.0 * lane_dot(s, v)
        reg = torch.stack([r2 * lane_dot(t, t) for r2, t in zip(reg2, th)]).sum(dim=0)
        return data + loss_const + reg

    for n_cg in num_cg_iter:
        s0, vjp_fn = vjp(net_fn, *theta)
        if collect_losses:
            losses.append(loss(s0, theta))

        def A(p, theta=theta, vjp_fn=vjp_fn):
            _, jp = jvp(net_fn, theta, tuple(p))
            back = vjp_fn(apply_stencil(M9, jp))
            return tuple(bb + r2 * pp for bb, pp, r2 in zip(back, p, reg2))

        back0 = vjp_fn(apply_stencil(M9, s0) - v)
        b = tuple(-(bb + r2 * th) for bb, th, r2 in zip(back0, theta, reg2))
        dx, state = _run_cg(A, b, state, n_cg, M1, direction_forget_factor, fletcher_reeves)
        theta = _axpy(state.step_alpha, dx, theta)
        state = replace(state, step_alpha=torch.clamp_max(state.step_alpha * 1.2, 1.0))
    if collect_losses:
        losses.append(loss(net_fn(*theta), theta))
        return theta, state, torch.stack(losses, dim=1)
    return theta, state


def scalar_preconditioner(diag_M):
    """M1(x) = x / diag_M with one scalar per block."""
    def M1(x):
        return tuple(xi / d for xi, d in zip(x, diag_M))
    return M1
