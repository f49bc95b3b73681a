"""Gauss-Newton / conjugate-gradient least-squares solver
(frtm_tpu/models/solver.py), on tuples of tensors.

One Gauss-Newton linearisation per entry of the CG schedule; preconditioned
CG with Polak-Ribiere beta clamped at 0, warm-started direction state with a
forgetting factor, the step_alpha ramp, and global-scalar inner products
summed over all parameter blocks. JAX's `linearize` / `linear_transpose`
become `torch.func.jvp` / `torch.func.vjp`, re-linearised at every GN
iteration (phase 1's conv(conv(x, project), filter) is bilinear, so the
linearisation point matters).
"""
from dataclasses import dataclass, replace
from typing import Tuple

import torch
from torch.func import jvp, vjp

from .lsq_stencil import apply_stencil


def tree_vdot(a, b) -> torch.Tensor:
    """Global inner product over all blocks (a scalar tensor)."""
    return torch.stack([torch.dot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b)]).sum()


def _axpy(a, x, y):
    return tuple(yi + a * xi for xi, yi in zip(x, y))


@dataclass
class CGState:
    """Warm-startable CG direction state."""
    p: Tuple[torch.Tensor, ...]
    r_prev: Tuple[torch.Tensor, ...]
    rho: torch.Tensor
    have_p: torch.Tensor
    step_alpha: torch.Tensor


def init_cg_state(theta_like, step_alpha: float = 1.0) -> CGState:
    dev = theta_like[0].device
    return CGState(
        p=tuple(torch.zeros_like(t) for t in theta_like),
        r_prev=tuple(torch.zeros_like(t) for t in theta_like),
        rho=torch.ones((), device=dev),
        have_p=torch.zeros((), dtype=torch.bool, device=dev),
        step_alpha=torch.tensor(step_alpha, dtype=torch.float32, device=dev),
    )


def _run_cg(A, b, state: CGState, n_iter: int, M1, direction_forget_factor):
    """One preconditioned CG solve of A x = b (Polak-Ribiere), warm-started
    from `state`; the last iteration skips the residual update."""
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
        num = rho - tree_vdot(r_prev, z)
        nonzero = rho1 != 0.0
        beta = torch.where(nonzero, num / torch.where(nonzero, rho1, torch.ones_like(rho1)),
                           torch.zeros_like(rho1))
        beta = torch.clamp_min(beta, 0.0)
        use_beta = torch.where(have_p, beta, torch.zeros_like(beta))
        p = tuple(zi + use_beta * pi for zi, pi in zip(z, p))
        q = A(p)
        pq = tree_vdot(p, q)
        alpha = torch.where(pq != 0.0, rho / pq, torch.zeros_like(pq))
        r_prev = r
        x = _axpy(alpha, p, x)
        if ii < n_iter - 1:
            r = _axpy(-alpha, q, r)
        have_p = torch.ones_like(have_p)
    return x, replace(state, p=p, r_prev=r_prev, rho=rho, have_p=have_p)


def gauss_newton_cg_quadform(net_fn, theta, state: CGState, num_cg_iter, M1,
                             direction_forget_factor: float, M9, v, regs):
    """GN-CG on ||W(U net(theta) - y)||^2 + sum ||reg_i theta_i||^2 with the
    label-space curvature as the precomputed score-space stencil M9 and the
    projected targets v (models/lsq_stencil.py).

    :param net_fn: (*theta) -> (S, h, w) score maps
    """
    reg2 = [r * r for r in regs]
    theta = tuple(theta)
    for n_cg in num_cg_iter:
        s0, vjp_fn = vjp(net_fn, *theta)

        def A(p, theta=theta, vjp_fn=vjp_fn):
            _, jp = jvp(net_fn, theta, tuple(p))
            back = vjp_fn(apply_stencil(M9, jp))
            return tuple(bb + r2 * pp for bb, pp, r2 in zip(back, p, reg2))

        back0 = vjp_fn(apply_stencil(M9, s0) - v)
        b = tuple(-(bb + r2 * th) for bb, th, r2 in zip(back0, theta, reg2))
        dx, state = _run_cg(A, b, state, n_cg, M1, direction_forget_factor)
        theta = _axpy(state.step_alpha, dx, theta)
        state = replace(state, step_alpha=torch.clamp_max(state.step_alpha * 1.2, 1.0))
    return theta, state


def scalar_preconditioner(diag_M):
    """M1(x) = x / diag_M with one scalar per block."""
    def M1(x):
        return tuple(xi / d for xi, d in zip(x, diag_M))
    return M1
