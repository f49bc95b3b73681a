"""The online target model D(x) = filter_3x3(project_1x1(x)), learned per
object by weighted least squares (frtm_tpu/models/discriminator.py): pixel
weights ('hinge', the eval setting, and the legacy 'none', 'fixed' and
'first-frame', per frame or global, with a distractor multiplier), a
two-phase init (a joint solve over {project, filter} on the augmented raw
features, then re-projection into a large memory and a filter-only solve
whose CG state persists), classification (optionally clamped to
(-0.1, 1.2)), and the online update that inserts every frame (labels and
weights per update method: 'frtm', or the legacy 'thresh', 'conf', 'raw',
'raw-conf') and re-solves every `train_skipping` frames. The solves run in
the stencil form (the eval path) or the direct residual form
(`cfg.solver`), and can report their loss trajectories (`collect_losses`).

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
from ..ops.resize import interpolate
from .solver import (CGState, gauss_newton_cg, gauss_newton_cg_quadform, init_cg_state,
                     scalar_preconditioner)


# the bounds of clamped scores (cfg.clamp_output)
CLAMP = (-0.1, 1.2)


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
    """sqrt of the per-pixel weights for labels y (N, 1, H, W), values in
    [0, 1] or > 1 for distractors:
      * 'none': weights 1;
      * 'fixed': foreground weighted to the target influence tf;
      * 'hinge': as fixed, but no reweighting once the area fraction af
        exceeds tf (the eval setting);
      * 'first-frame': every sample takes the first sample's af;
      * pixel_weighting_per_frame=False: af over all samples at once;
      * distractor_mult: a factor on the weight where labels > 1.
    Objects under 10 px count as af = tf. Kept on purpose, as in the JAX
    package: the weight interpolates with the raw label values, so a
    distractor label (> 1) on a large object gives a negative weight and
    sqrt makes it NaN."""
    method = cfg.pixel_weighting_method
    if method == "none":
        return torch.ones_like(y, dtype=torch.float32)
    if method not in ("fixed", "hinge", "first-frame"):
        raise ValueError(f"unknown pixel_weighting_method {method!r}")
    tf = cfg.pixel_weighting_tf
    y = y.float()
    N, _, H, W = y.shape
    if cfg.pixel_weighting_per_frame:
        px = y.sum(dim=(1, 2, 3)).reshape(N, 1, 1, 1)
        af = px / (H * W)
    else:
        px = y.sum() * torch.ones((N, 1, 1, 1), device=y.device)
        af = px / y.numel()
    af = torch.where(px < 10, torch.full_like(af, tf), af)
    if method == "first-frame":
        af = af[0:1].expand_as(af)
    if method == "fixed":
        tf_eff = torch.full_like(af, tf)
    else:
        tf_eff = torch.where(af > tf, af, torch.full_like(af, tf))
    wf = tf_eff / af
    wf = torch.where(torch.isfinite(wf), wf, torch.ones_like(wf))
    wb = (1.0 - tf_eff) / (1.0 - af)
    wb = torch.where(torch.isfinite(wb), wb, torch.ones_like(wb))
    w = wf * y + wb * (1.0 - y)
    if cfg.distractor_mult != 1.0:
        w = torch.where(y > 1, w * cfg.distractor_mult, w)
    return torch.sqrt(w)


def _solve(memory: MemoryState, regs, precond, net_fn, theta, state, schedule,
           cfg: DiscConfig, score_hw, collect_losses: bool = False):
    """One GN-CG schedule on the memory's weighted LSQ problem, in the form
    cfg.solver names. net_fn(*theta, x) -> (S, 1, h, w). With collect_losses
    the result also holds the loss before each GN iteration and after the
    last, the same quantity in both forms."""
    M1 = scalar_preconditioner(tuple(float(p) for p in precond))
    dff = cfg.direction_forget_factor
    w = memory.pixel_weights * torch.sqrt(memory.weights).reshape(-1, 1, 1, 1)
    x = memory.samples
    if cfg.solver == "residual":
        y = memory.labels

        def residuals(*th):
            s = interpolate(net_fn(*th, x), y.shape[-2:])
            return (w * (s - y),) + tuple(r * t for r, t in zip(regs, th))

        return gauss_newton_cg(residuals, theta, state, schedule, M1, dff,
                               collect_losses=collect_losses)
    if cfg.solver != "stencil":
        raise ValueError(f"unknown solver {cfg.solver!r}: 'stencil' or 'residual'")
    w2 = torch.square(w)[:, 0]                                   # (S, H, W)
    M9 = precompute_stencil(w2, score_hw)
    v = project_targets(w2, memory.labels[:, 0], score_hw)

    def scores(*th):
        return net_fn(*th, x)[:, 0]

    loss_const = torch.dot(w2.reshape(-1), torch.square(memory.labels[:, 0]).reshape(-1)) \
        if collect_losses else 0.0
    return gauss_newton_cg_quadform(scores, theta, state, schedule, M1, dff, M9, v, regs,
                                    collect_losses=collect_losses, loss_const=loss_const)


def _joint_net(project, filt, x):
    return conv2d(conv2d(x, project), filt)


def _filter_net(filt, x):
    return conv2d(x, filt)


def disc_init(params: DiscParams, features, labels, cfg: DiscConfig,
              collect_losses: bool = False):
    """Two-phase target-model initialisation.

    :param features: (K, Cin, h, w) augmented first-frame features
    :param labels:   (K, 1, H, W) augmented masks
    :param collect_losses: also return {'init': (len(init_iters) + 1,),
        'update': (len(update_iters) + 1,)} loss trajectories of the two solves
    :return: (DiscParams, DiscState[, losses])
    """
    pw = compute_pixel_weights(labels, cfg)
    K = features.shape[0]
    score_hw = tuple(features.shape[-2:])

    mem1 = memory_init(K, features, labels, pw)
    theta = (params.project, params.filter)
    out1 = _solve(mem1, cfg.filter_reg, cfg.precond, _joint_net, theta,
                  init_cg_state(theta), cfg.init_iters, cfg, score_hw, collect_losses)
    params = DiscParams(*out1[0])

    compressed = conv2d(features, params.project)
    mem2 = memory_init(cfg.memory_size, compressed, labels, pw)
    theta_f = (params.filter,)
    out2 = _solve(mem2, cfg.filter_reg[1:], cfg.precond[1:], _filter_net, theta_f,
                  init_cg_state(theta_f), cfg.update_iters, cfg, score_hw, collect_losses)
    params = params._replace(filter=out2[0][0])
    state = DiscState(memory=mem2, cg=out2[1], frame_num=0)
    if collect_losses:
        return params, state, {"init": out1[2], "update": out2[2]}
    return params, state


def disc_apply(params: DiscParams, ft, clamp_output: bool = False):
    """Classify features: (coarse scores (N, 1, h, w), compressed sample);
    clamp_output bounds the scores to (-0.1, 1.2)."""
    cft = conv2d(ft, params.project)
    scores = conv2d(cft, params.filter)
    return (scores.clamp(*CLAMP) if clamp_output else scores), cft


def online_update_weights(train_y, cfg: DiscConfig):
    """Label and pixel weights of an online memory insert, per update method:
    'frtm' stores the soft mask with weights from the thresholded mask;
    'thresh' stores the thresholded mask; 'conf' too, its weights scaled by
    the square root of the confidence 2 |0.5 - y|; 'raw' stores the soft
    mask with weights 1; 'raw-conf' with the confidence as weights.
    :param train_y: (1, H, W) soft mask -> (label, pixel weights), (1, H, W)"""
    m = cfg.update_method
    if m in ("frtm", "thresh", "conf"):
        ys = (train_y > 0.5).float()
        pw = compute_pixel_weights(ys[None], cfg)[0]
        if m == "frtm":
            return train_y, pw
        if m == "thresh":
            return ys, pw
        return ys, torch.sqrt(2.0 * torch.abs(0.5 - train_y)) * pw
    if m == "raw":
        return train_y, torch.ones_like(train_y)
    if m == "raw-conf":
        return train_y, 2.0 * torch.abs(train_y - 0.5)
    raise ValueError(f"unknown update_method: {m}")


def filter_resolve(params: DiscParams, state: DiscState, cfg: DiscConfig,
                   collect_losses: bool = False):
    """Filter-only re-solve on the current memory, warm-started from the
    carried CG state. Returns (params, cg[, losses])."""
    score_hw = tuple(state.memory.samples.shape[-2:])
    out = _solve(state.memory, cfg.filter_reg[1:], cfg.precond[1:], _filter_net,
                 (params.filter,), state.cg, cfg.update_iters, cfg, score_hw, collect_losses)
    return (params._replace(filter=out[0][0]),) + tuple(out[1:])


def disc_update(params: DiscParams, state: DiscState, compressed_sample, train_y,
                cfg: DiscConfig):
    """Per-frame online update: skip when the soft mask has < 10 foreground
    pixels, else insert into memory and re-solve every `train_skipping`-th
    frame.

    :param compressed_sample: (c, h, w) from disc_apply
    :param train_y: (1, H, W) merged soft mask of this object
    """
    state.frame_num += 1
    if not cfg.update_filters:
        return params, state
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


def classify_objects(compressed, filters, clamp_output: bool = False):
    """N filters on N projected maps as one grouped convolution; clamp_output
    bounds the scores to (-0.1, 1.2).

    :param compressed: (B, N, c, h, w)
    :param filters: N weights (1, c, 3, 3)
    :return: (B, N, h, w) coarse scores
    """
    B, N, c, h, w = compressed.shape
    weight = torch.cat(list(filters))
    if tuple(weight.shape) != (N, c, 3, 3):
        raise ValueError(f"classify_objects: filters {tuple(weight.shape)} for "
                         f"{N} objects of {c} channels")
    scores = F.conv2d(compressed.reshape(B, N * c, h, w), weight, padding=1, groups=N)
    return scores.clamp(*CLAMP) if clamp_output else scores


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
