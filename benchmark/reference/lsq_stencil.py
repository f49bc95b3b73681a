"""Exact score-resolution reduction of the target model's weighted
least-squares operator (frtm_tpu/models/lsq_stencil.py).

The loss ||W (U s - y)||^2 has curvature U' diag(w^2) U in score space, and
because each bilinear row of U touches at most two source cells per axis it
is an exact 3x3 stencil on the score grid. One full-resolution pass per
solve precomputes the nine coefficient maps and the projected targets; every
CG iteration then works at score resolution.
"""
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .resize import _linear_matrix


@lru_cache(maxsize=None)
def _shifted_products(in_size, out_size):
    """P_d[Y, a] = U[Y, a] * U[Y, a+d] for d in (-1, 0, 1): (3, out, in)."""
    U = _linear_matrix(in_size, out_size).astype(np.float64)
    out = np.zeros((3, out_size, in_size), np.float64)
    for di, d in enumerate((-1, 0, 1)):
        a0, a1 = max(0, -d), min(in_size, in_size - d)
        out[di, :, a0:a1] = U[:, a0:a1] * U[:, a0 + d:a1 + d]
    return out.astype(np.float32)


@lru_cache(maxsize=64)
def _on(device: torch.device, matrix, in_size: int, out_size: int) -> torch.Tensor:
    """One of the constant matrices above on `device`, uploaded once: an
    upload per solve would stall the host on the card's queue each time."""
    return torch.from_numpy(matrix(in_size, out_size)).to(device)


def precompute_stencil(w2, score_hw):
    """:param w2: (S, H, W) squared residual weights
    :return: (S, 3, 3, h, w) stencil maps"""
    S, H, W = w2.shape
    h, w = score_hw
    Ph = _on(w2.device, _shifted_products, h, H)   # (3, H, h)
    Pw = _on(w2.device, _shifted_products, w, W)   # (3, W, w)
    row = torch.einsum("dYa,SYX->dSaX", Ph, w2)
    return torch.einsum("dSaX,eXb->Sdeab", row, Pw)


def project_targets(w2, y, score_hw):
    """v = U'(w^2 * y) at score resolution: (S, h, w)."""
    S, H, W = w2.shape
    h, w = score_hw
    Uh = _on(w2.device, _linear_matrix, h, H)
    Uw = _on(w2.device, _linear_matrix, w, W)
    g = torch.einsum("Ya,SYX->SaX", Uh, w2 * y)
    return torch.einsum("SaX,Xb->Sab", g, Uw)


def apply_stencil(M9, s):
    """M(s) = sum over the 3x3 neighbourhood of M9 * shifted(s).
    M9: (..., 3, 3, h, w), s: (..., h, w) -> (..., h, w); the leading axes
    (samples, or objects and samples) are independent."""
    h, w = s.shape[-2], s.shape[-1]
    sp = F.pad(s, (1, 1, 1, 1))
    out = torch.zeros_like(s)
    for di in range(3):
        for dj in range(3):
            out = out + M9[..., di, dj, :, :] * sp[..., di:di + h, dj:dj + w]
    return out
