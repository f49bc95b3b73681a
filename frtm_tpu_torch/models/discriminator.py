"""The online target model D(x) = filter_3x3(project_1x1(x)), learned per
object by weighted least squares (frtm_tpu/models/discriminator.py): hinge
pixel weights, a two-phase init (a joint solve over {project, filter} on the
augmented raw features, then re-projection into a large memory and a
filter-only solve whose CG state persists), classification, and the online
update that inserts every frame and re-solves every `train_skipping` frames.

The JAX update's `lax.cond` becomes a host branch in the host loop:
`disc_update` reads the foreground count once per frame (one device sync)
and decides there. The fused tracker's pieces read nothing on the host:
`insert_sample` gates the insert with a tensor and `resolve_due` selects
between the old and the re-solved filter with one. Objects are a list of
(DiscParams, DiscState); `project_all` and `classify_objects` apply all of
them in one convolution each.
Weights are OIHW: project (c, Cin, 1, 1), filter (out, c, 3, 3).
"""
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DiscConfig
from ..device import resolve_device
from ..ops.conv import conv2d
from .lsq_stencil import precompute_stencil, project_targets
from .memory import MemoryState, memory_init, memory_update
from .solver import CGState, gauss_newton_cg_quadform, init_cg_state, scalar_preconditioner


class DiscParams(NamedTuple):
    project: torch.Tensor  # (c, Cin, 1, 1)
    filter: torch.Tensor   # (out, c, 3, 3)


@dataclass
class DiscState:
    memory: MemoryState
    cg: CGState
    frame_num: int
    n_resolves: object = 0   # int (host loop) or int64 device scalar (fused)


def init_disc_params(cfg: DiscConfig, generator: torch.Generator, device=None) -> DiscParams:
    """torch Conv2d default scale (kaiming_uniform a=sqrt(5)); the solve
    overwrites these, so only the scale matters."""
    b1 = float(np.sqrt(6.0 / (6.0 * cfg.in_channels)))
    b2 = float(np.sqrt(6.0 / (6.0 * 9 * cfg.c_channels)))
    project = (torch.rand((cfg.c_channels, cfg.in_channels, 1, 1), generator=generator)
               * 2 - 1) * b1
    filt = (torch.rand((cfg.out_channels, cfg.c_channels, 3, 3), generator=generator)
            * 2 - 1) * b2
    dev = resolve_device(device)
    return DiscParams(project.to(dev), filt.to(dev))


def compute_pixel_weights(y, cfg: DiscConfig):
    """sqrt of the 'hinge' per-pixel weights (the eval setting) for labels
    y (N, 1, H, W) in [0, 1], per frame: foreground weighted to the target
    influence tf until its area fraction af exceeds tf; objects under 10 px
    count as af = tf."""
    if (cfg.pixel_weighting_method != "hinge" or not cfg.pixel_weighting_per_frame
            or cfg.distractor_mult != 1.0):
        raise NotImplementedError("only per-frame 'hinge' pixel weighting is ported")
    tf = cfg.pixel_weighting_tf
    y = y.float()
    N, _, H, W = y.shape
    px = y.sum(dim=(1, 2, 3)).reshape(N, 1, 1, 1)
    af = torch.where(px < 10, torch.full_like(px, tf), px / (H * W))
    tf_eff = torch.where(af > tf, af, torch.full_like(af, tf))
    wf = tf_eff / af
    wf = torch.where(torch.isfinite(wf), wf, torch.ones_like(wf))
    wb = (1.0 - tf_eff) / (1.0 - af)
    wb = torch.where(torch.isfinite(wb), wb, torch.ones_like(wb))
    return torch.sqrt(wf * y + wb * (1.0 - y))


def _solve(memory: MemoryState, regs, precond, net_fn, theta, state, schedule,
           cfg: DiscConfig, score_hw):
    """One GN-CG schedule on the memory's weighted LSQ problem (stencil
    form). net_fn(*theta, x) -> (S, 1, h, w)."""
    if cfg.solver != "stencil":
        raise NotImplementedError(f"solver {cfg.solver!r} is not ported (only 'stencil')")
    M1 = scalar_preconditioner(tuple(float(p) for p in precond))
    sw = torch.sqrt(memory.weights).reshape(-1, 1, 1, 1)
    w2 = torch.square(memory.pixel_weights * sw)[:, 0]          # (S, H, W)
    M9 = precompute_stencil(w2, score_hw)
    v = project_targets(w2, memory.labels[:, 0], score_hw)
    x = memory.samples

    def scores(*th):
        return net_fn(*th, x)[:, 0]

    return gauss_newton_cg_quadform(scores, theta, state, schedule, M1,
                                    cfg.direction_forget_factor, M9, v, regs)


def _joint_net(project, filt, x):
    return conv2d(conv2d(x, project), filt)


def _filter_net(filt, x):
    return conv2d(x, filt)


def disc_init(params: DiscParams, features, labels, cfg: DiscConfig):
    """Two-phase target-model initialisation.

    :param features: (K, Cin, h, w) augmented first-frame features
    :param labels:   (K, 1, H, W) augmented masks
    :return: (DiscParams, DiscState)
    """
    pw = compute_pixel_weights(labels, cfg)
    K = features.shape[0]
    score_hw = tuple(features.shape[-2:])

    mem1 = memory_init(K, features, labels, pw)
    theta = (params.project, params.filter)
    theta, _ = _solve(mem1, cfg.filter_reg, cfg.precond, _joint_net, theta,
                      init_cg_state(theta), cfg.init_iters, cfg, score_hw)
    params = DiscParams(*theta)

    compressed = conv2d(features, params.project)
    mem2 = memory_init(cfg.memory_size, compressed, labels, pw)
    theta_f = (params.filter,)
    theta_f, cg = _solve(mem2, cfg.filter_reg[1:], cfg.precond[1:], _filter_net, theta_f,
                         init_cg_state(theta_f), cfg.update_iters, cfg, score_hw)
    return params._replace(filter=theta_f[0]), DiscState(memory=mem2, cg=cg, frame_num=0)


def disc_apply(params: DiscParams, ft):
    """Classify features: (coarse scores (N, 1, h, w), compressed sample)."""
    cft = conv2d(ft, params.project)
    return conv2d(cft, params.filter), cft


def online_update_weights(train_y, cfg: DiscConfig):
    """'frtm' update: store the soft mask, weights from the thresholded mask.
    :param train_y: (1, H, W) soft mask -> (label, pixel weights), (1, H, W)"""
    if cfg.update_method != "frtm":
        raise NotImplementedError(f"update_method {cfg.update_method!r} is not ported")
    ys = (train_y > 0.5).float()
    return train_y, compute_pixel_weights(ys[None], cfg)[0]


def filter_resolve(params: DiscParams, state: DiscState, cfg: DiscConfig):
    """Filter-only re-solve on the current memory, warm-started from the
    carried CG state."""
    score_hw = tuple(state.memory.samples.shape[-2:])
    theta_f, cg = _solve(state.memory, cfg.filter_reg[1:], cfg.precond[1:], _filter_net,
                         (params.filter,), state.cg, cfg.update_iters, cfg, score_hw)
    return params._replace(filter=theta_f[0]), cg


def disc_update(params: DiscParams, state: DiscState, compressed_sample, train_y,
                cfg: DiscConfig):
    """Per-frame online update: skip when the soft mask has < 10 foreground
    pixels, else insert into memory and re-solve every `train_skipping`-th
    frame.

    :param compressed_sample: (c, h, w) from disc_apply
    :param train_y: (1, H, W) merged soft mask of this object
    """
    if not cfg.update_filters:
        state.frame_num += 1
        return params, state
    state.frame_num += 1
    enough_fg = int((train_y > 0.5).sum()) >= 10      # the frame's one sync
    label, pw = online_update_weights(train_y, cfg)
    state.memory = memory_update(state.memory, compressed_sample, label, pw,
                                 cfg.learning_rate, enabled=enough_fg)
    if enough_fg and state.frame_num % cfg.train_skipping == 0:
        params, state.cg = filter_resolve(params, state, cfg)
        state.n_resolves += 1
    return params, state


# -- the fused tracker's pieces: N objects, nothing read on the host ---------


def project_all(features, projects):
    """Every object's projection of every frame in one 1x1 convolution.

    :param features: (T, Cin, h, w)
    :param projects: N weights (c, Cin, 1, 1)
    :return: (T, N, c, h, w)
    """
    out = conv2d(features, torch.cat(list(projects)))
    return out.view(features.shape[0], len(projects), -1, *features.shape[-2:])


def classify_objects(compressed, filters):
    """N filters on N projected maps as one grouped convolution.

    :param compressed: (B, N, c, h, w)
    :param filters: N weights (1, c, 3, 3)
    :return: (B, N, h, w) coarse scores
    """
    B, N, c, h, w = compressed.shape
    weight = torch.cat(list(filters))
    if tuple(weight.shape) != (N, c, 3, 3):
        raise ValueError(f"classify_objects: filters {tuple(weight.shape)} for "
                         f"{N} objects of {c} channels")
    return F.conv2d(compressed.reshape(B, N * c, h, w), weight, padding=1, groups=N)


def insert_sample(state: DiscState, compressed_sample, train_y, enabled, cfg: DiscConfig):
    """One tracked frame of one object: the memory insert, gated at the row
    by the 0-dim bool tensor `enabled` (>= 10 foreground pixels), and the
    frame counter, which advances whatever the mask holds."""
    label, pw = online_update_weights(train_y, cfg)
    state.memory = memory_update(state.memory, compressed_sample, label, pw,
                                 cfg.learning_rate, enabled=enabled)
    state.frame_num += 1


def resolve_due(params: DiscParams, state: DiscState, due, cfg: DiscConfig) -> DiscParams:
    """Filter re-solve whose result is taken where the 0-dim bool tensor
    `due` holds: only the filter and the CG state pass through the select,
    the memory buffers are read by the solve and never copied."""
    new_params, new_cg = filter_resolve(params, state, cfg)

    def sel(a, b):
        return torch.where(due, a, b)

    cg = state.cg
    state.cg = replace(cg, p=tuple(map(sel, new_cg.p, cg.p)),
                       r_prev=tuple(map(sel, new_cg.r_prev, cg.r_prev)),
                       rho=sel(new_cg.rho, cg.rho), have_p=sel(new_cg.have_p, cg.have_p),
                       step_alpha=sel(new_cg.step_alpha, cg.step_alpha))
    state.n_resolves = state.n_resolves + due.long()
    return params._replace(filter=sel(new_params.filter, params.filter))
