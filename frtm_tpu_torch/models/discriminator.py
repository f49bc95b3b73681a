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

Every function takes N objects at once, as the JAX package's `jax.vmap`
over objects does: the weights, the memory and the CG state carry a
leading object axis, the nets are batched matrix products over the lanes
(lane_project, lane_filter: cuDNN runs a grouped convolution as a loop over
its groups, so its launches would grow with N), and one solve serves all
lanes. The host loop calls them with N = 1.

The JAX update's `lax.cond` becomes a host branch in the host loop:
`disc_update` reads the foreground count once per frame (one device sync)
and decides there. The fused tracker's pieces read nothing on the host:
`insert_sample` gates the insert with an (N,) tensor and `resolve_due`
selects, per lane, between the old and the re-solved filter with one.
Weights are OIHW behind the object axis: project (N, c, Cin, 1, 1), filter
(N, out, c, 3, 3).

A filter re-solve on the card issues several hundred small launches (ten CG
steps of jvp, vjp, stencil and inner products on tensors of a few hundred
thousand elements), so the host's issue, not the card, sets its time.
`filter_resolve` and `resolve_due` therefore replay it as a CUDA graph
(utils/cuda_graphs.py), one per `resolve_graph_key`, where `eager_reasons`
finds nothing against it: CUDA tensors, the stencil form, no loss
trajectories, no gradient wanted, no capture under way. The stencil's
precompute (`_stencil_terms`, a handful of launches over the full-resolution
label and weight stores) runs eagerly; the graph runs the GN-CG schedule and
the `due` select on copies of the compressed samples, the stencil terms, the
filter and the CG state. Elsewhere, and at a key's first call, the same
functions run eagerly. The two-phase init makes some thousands of such
launches (55 CG steps and 6 linearisations at the eval settings), and
`disc_init_graphed` replays it whole as a graph per `init_graph_key`, under
`init_eager_reasons`' rule: the pixel weights, both memories, both stencil
precomputes and both solves, from the starting weights, the features and
the labels. `disc_init` is the same work run eagerly.
"""
from dataclasses import dataclass, replace
from functools import lru_cache, partial
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DiscConfig
from ..device import resolve_device
from ..ops.conv import conv2d
from .lsq_stencil import precompute_stencil, project_targets
from .memory import MemoryState, memory_init, memory_update
from ..ops.resize import interpolate
from ..utils import profiling
from ..utils.cuda_graphs import GraphCache
from .solver import (CGState, gauss_newton_cg, gauss_newton_cg_quadform, init_cg_state,
                     lane_dot, lanes, scalar_preconditioner)


# the bounds of clamped scores (cfg.clamp_output)
CLAMP = (-0.1, 1.2)


class DiscParams(NamedTuple):
    """One model's weights, (c, Cin, 1, 1) and (out, c, 3, 3), as starting
    weights and in the cache; N models' with a leading object axis, as the
    functions below take them."""
    project: torch.Tensor  # (N, c, Cin, 1, 1)
    filter: torch.Tensor   # (N, out, c, 3, 3)


@dataclass
class DiscState:
    memory: MemoryState
    cg: CGState
    frame_num: List[int]       # per lane, on the host: tracked frames so far
    n_resolves: torch.Tensor   # (N,) int64 on the device: filter re-solves


def repeat_params(params: DiscParams, n: int) -> DiscParams:
    """One model's weights as the starting weights of n objects."""
    return DiscParams(*(t.unsqueeze(0).repeat((n,) + (1,) * t.dim()) for t in params))


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
    """sqrt of the per-pixel weights for the K labels y (..., K, 1, H, W)
    of each object on the leading axes, values in [0, 1] or > 1 for
    distractors:
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
    K, H, W = y.shape[-4], y.shape[-2], y.shape[-1]
    if cfg.pixel_weighting_per_frame:
        px = y.sum(dim=(-3, -2, -1), keepdim=True)
        af = px / (H * W)
    else:
        px = y.sum(dim=(-4, -3, -2, -1), keepdim=True) * torch.ones(
            (K, 1, 1, 1), device=y.device)
        af = px / (K * H * W)
    af = torch.where(px < 10, torch.full_like(af, tf), af)
    if method == "first-frame":
        af = af[..., 0:1, :, :, :].expand_as(af)
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


def lane_project(x, project):
    """Each lane's 1x1 projection by its own weights, as one batched matrix
    product: x (N, S, Cin, h, w), project (N, c, Cin, 1, 1) -> (N, S, c, h, w)."""
    N, S, cin, h, w = x.shape
    out = torch.matmul(project.flatten(2)[:, None], x.reshape(N, S, cin, h * w))
    return out.view(N, S, -1, h, w)


@lru_cache(maxsize=None)
def _tap_sum_weight(out: int, device: torch.device) -> torch.Tensor:
    """(out, 9 * out, 3, 3) one-hot weight: a convolution with it sums, for
    each output, its nine tap maps, each shifted to its tap. Uploaded once
    per device and kept for the process's life: a replayed re-solve graph
    reads it at the address it was captured with."""
    weight = torch.zeros(out, out * 9, 3, 3)
    for o in range(out):
        for k in range(9):
            weight[o, o * 9 + k, k // 3, k % 3] = 1.0
    return weight.to(device)


def lane_filter(x, filt):
    """Each lane's 3x3 filter (k//2 padding) by its own weights: x
    (N, S, c, h, w), filt (N, out, c, 3, 3) -> (N, S, out, h, w). One batched
    matrix product gives every tap's map, (N, S, 9 * out, h, w), and one
    convolution with a fixed one-hot weight shifts and sums them, in a
    number of launches that does not grow with N."""
    N, S, c, h, w = x.shape
    out = filt.shape[1]
    taps = filt.permute(0, 1, 3, 4, 2).reshape(N, 1, out * 9, c)
    maps = torch.matmul(taps, x.reshape(N, S, c, h * w)).view(N * S, out * 9, h, w)
    return conv2d(maps, _tap_sum_weight(out, x.device)).view(N, S, out, h, w)


def _solve(memory: MemoryState, regs, precond, net_fn, theta, state, schedule,
           cfg: DiscConfig, score_hw, collect_losses: bool = False):
    """One GN-CG schedule on the memory's weighted LSQ problem of every
    lane at once, in the form cfg.solver names. net_fn(*theta, x) ->
    (N, S, 1, h, w) with x the memory's samples. With collect_losses the
    result also holds the loss before each GN iteration and after the last,
    (N, len(schedule) + 1), the same quantity in both forms."""
    M1 = scalar_preconditioner(tuple(float(p) for p in precond))
    dff = cfg.direction_forget_factor
    N, S = memory.weights.shape
    x = memory.samples
    if cfg.solver == "residual":
        w = _residual_weights(memory)
        y = memory.labels

        def residuals(*th):
            s = interpolate(net_fn(*th, x).flatten(0, 1), y.shape[-2:]).unflatten(0, (N, S))
            return (w * (s - y),) + tuple(r * t for r, t in zip(regs, th))

        return gauss_newton_cg(residuals, theta, state, schedule, M1, dff,
                               collect_losses=collect_losses)
    if cfg.solver != "stencil":
        raise ValueError(f"unknown solver {cfg.solver!r}: 'stencil' or 'residual'")
    w2, y, M9, v = _stencil_terms(memory, score_hw)

    def scores(*th):
        return net_fn(*th, x)[:, :, 0]

    loss_const = lane_dot(w2, torch.square(y)) if collect_losses else 0.0
    return gauss_newton_cg_quadform(scores, theta, state, schedule, M1, dff, M9, v, regs,
                                    collect_losses=collect_losses, loss_const=loss_const)


def _residual_weights(memory: MemoryState):
    """The residual weights w = pixel weight x sqrt(sample weight):
    (N, S, 1, H, W)."""
    N, S = memory.weights.shape
    return memory.pixel_weights * torch.sqrt(memory.weights).reshape(N, S, 1, 1, 1)


def _stencil_terms(memory: MemoryState, score_hw):
    """The stencil form's full-resolution precompute: w^2 and the labels,
    (N, S, H, W), the stencil maps M9 (N, S, 3, 3, h, w) and the projected
    targets v (N, S, h, w)."""
    N, S = memory.weights.shape
    w2 = torch.square(_residual_weights(memory))[:, :, 0]
    y = memory.labels[:, :, 0]
    M9 = precompute_stencil(w2.flatten(0, 1), score_hw).unflatten(0, (N, S))
    v = project_targets(w2.flatten(0, 1), y.flatten(0, 1), score_hw).unflatten(0, (N, S))
    return w2, y, M9, v


def _joint_net(project, filt, x):
    return lane_filter(lane_project(x, project), filt)


def _filter_net(filt, x):
    return lane_filter(x, filt)


def _init_body(cfg: DiscConfig, project, filt, features, labels, collect_losses: bool = False):
    """The two-phase init as tensors in and tensors out, which an init graph
    captures: the pixel weights, phase 1's memory and joint solve over
    {project, filter} from the starting weights, phase 2's memory of the
    re-projected features and its filter-only solve. Returns project, filter,
    the memory's samples, labels, pixel_weights, weights, current_size and
    prev_ind, and the CG state's p, r_prev, rho, have_p and step_alpha (with
    collect_losses also the two solves' loss trajectories)."""
    pw = compute_pixel_weights(labels, cfg)
    K = features.shape[1]
    score_hw = tuple(features.shape[-2:])
    theta = (project, filt)
    out1 = _solve(memory_init(K, features, labels, pw), cfg.filter_reg, cfg.precond, _joint_net,
                  theta, init_cg_state(theta), cfg.init_iters, cfg, score_hw, collect_losses)
    project, filt = out1[0]
    mem = memory_init(cfg.memory_size, lane_project(features, project), labels, pw)
    out2 = _solve(mem, cfg.filter_reg[1:], cfg.precond[1:], _filter_net, (filt,),
                  init_cg_state((filt,)), cfg.update_iters, cfg, score_hw, collect_losses)
    cg = out2[1]
    return (project, out2[0][0], mem.samples, mem.labels, mem.pixel_weights, mem.weights,
            mem.current_size, mem.prev_ind, cg.p[0], cg.r_prev[0], cg.rho, cg.have_p,
            cg.step_alpha) + ((out1[2], out2[2]) if collect_losses else ())


def _init_models(out):
    """(DiscParams, DiscState) of N lanes from _init_body's tensors."""
    project, filt, samples, labels, pw, weights, size, prev, p, r_prev, rho, have_p, alpha = out
    n = project.shape[0]
    state = DiscState(memory=MemoryState(samples, labels, pw, weights, size, prev),
                      cg=CGState(p=(p,), r_prev=(r_prev,), rho=rho, have_p=have_p,
                                 step_alpha=alpha),
                      frame_num=[0] * n,
                      n_resolves=torch.zeros(n, dtype=torch.int64, device=project.device))
    return DiscParams(project, filt), state


def disc_init(params: DiscParams, features, labels, cfg: DiscConfig,
              collect_losses: bool = False):
    """Two-phase target-model initialisation of N objects at once, run
    eagerly (`disc_init_graphed` replays it as a CUDA graph).

    :param params: starting weights with the object axis (repeat_params)
    :param features: (N, K, Cin, h, w) augmented first-frame features
    :param labels:   (N, K, 1, H, W) augmented masks
    :param collect_losses: also return {'init': (N, len(init_iters) + 1),
        'update': (N, len(update_iters) + 1)} loss trajectories of the two
        solves
    :return: (DiscParams, DiscState[, losses])
    """
    out = _init_body(cfg, *params, features, labels, collect_losses)
    models = _init_models(out[:13])
    if collect_losses:
        return models + ({"init": out[13], "update": out[14]},)
    return models


# the init graphs of the process: a key for each lane count and input shape
# met (five in a DAVIS pass of 1-5 objects). Each pins a pool of about half a
# GB a lane at 480x854, most of it phase 2's full-resolution label and
# weight stores, so the cache stays small.
INIT_GRAPHS = GraphCache(maxsize=6)


def init_eager_reasons(params: DiscParams, features, labels, cfg: DiscConfig,
                       collect_losses: bool = False) -> list:
    """Why an init runs eagerly rather than as a CUDA graph: an empty list
    where the graph may serve it."""
    return _graph_refusals((*params, features, labels), cfg, collect_losses)


def init_graph_key(params: DiscParams, features, labels, cfg: DiscConfig) -> tuple:
    """Everything that changes an init graph's captured work: the device,
    the lane count, the shapes and dtypes of the features, labels and
    weights, both schedules, the memory's size, and the constants of the
    solves and of the pixel weighting."""
    return (features.device, features.shape[0],
            tuple((tuple(t.shape), t.dtype) for t in (*params, features, labels)),
            tuple(int(n) for n in cfg.init_iters), tuple(int(n) for n in cfg.update_iters),
            tuple(float(r) for r in cfg.filter_reg), tuple(float(p) for p in cfg.precond),
            float(cfg.direction_forget_factor), int(cfg.memory_size),
            cfg.pixel_weighting_method, float(cfg.pixel_weighting_tf),
            bool(cfg.pixel_weighting_per_frame), float(cfg.distractor_mult))


def disc_init_graphed(params: DiscParams, features, labels, cfg: DiscConfig):
    """disc_init, replayed as a CUDA graph, one per `init_graph_key`, where
    `init_eager_reasons` finds nothing against it; elsewhere, and at a key's
    first call, run eagerly. The trackers' inits take it: their lane count
    is the sequence's object count, which repeats from sequence to sequence.
    The trainer's cold start and ml_disc_init call disc_init: a batch's
    misses change its lane count from batch to batch, and each count's
    graph would pin its own pool. The counter `init_replays` adds 1 for a
    call a replay served, 0 for one run eagerly; `inits` adds 1 a call."""
    out = None
    if not init_eager_reasons(params, features, labels, cfg):
        out = INIT_GRAPHS.run(init_graph_key(params, features, labels, cfg),
                              lambda *a: _init_body(cfg, *a), lambda: (*params, features, labels))
    profiling.count("inits")
    profiling.count("init_replays", int(out is not None))
    return disc_init(params, features, labels, cfg) if out is None else _init_models(out)


def disc_apply(params: DiscParams, ft, clamp_output: bool = False):
    """Classify features (B, Cin, h, w) with N models: (coarse scores
    (B, N * out, h, w), compressed samples (B, N, c, h, w)); clamp_output
    bounds the scores to (-0.1, 1.2)."""
    cft = project_all(ft, params.project)
    return classify_objects(cft, params.filter, clamp_output), cft


def online_update_weights(train_y, cfg: DiscConfig):
    """Label and pixel weights of an online memory insert, per update method:
    'frtm' stores the soft mask with weights from the thresholded mask;
    'thresh' stores the thresholded mask; 'conf' too, its weights scaled by
    the square root of the confidence 2 |0.5 - y|; 'raw' stores the soft
    mask with weights 1; 'raw-conf' with the confidence as weights.
    :param train_y: (..., 1, H, W) soft masks, one sample each -> (label,
        pixel weights), (..., 1, H, W)"""
    m = cfg.update_method
    if m in ("frtm", "thresh", "conf"):
        ys = (train_y > 0.5).float()
        pw = compute_pixel_weights(ys.unsqueeze(-4), cfg).squeeze(-4)
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


# the re-solve graphs of the process: a key for each lane count, memory and
# configuration met (five in a DAVIS pass of 1-5 objects), with room for the
# layers of a multilayer model and the sharded engine's lane counts
RESOLVE_GRAPHS = GraphCache(maxsize=16)


def eager_reasons(params: DiscParams, state: DiscState, cfg: DiscConfig,
                  collect_losses: bool = False) -> list:
    """Why a filter re-solve runs eagerly rather than as a CUDA graph: an
    empty list where the graph may serve it."""
    m, cg = state.memory, state.cg
    return _graph_refusals((params.filter, m.samples, m.labels, m.pixel_weights, m.weights,
                            *cg.p, *cg.r_prev, cg.rho, cg.step_alpha), cfg, collect_losses)


def _graph_refusals(tensors, cfg: DiscConfig, collect_losses: bool) -> list:
    """What keeps a solve over `tensors` from a CUDA graph: tensors off the
    card, a capture under way, the residual form, loss trajectories, a
    gradient wanted."""
    reasons = []
    if not all(t.is_cuda for t in tensors):
        reasons.append("not on CUDA")
    elif torch.cuda.is_current_stream_capturing():
        reasons.append("a capture is under way")
    if cfg.solver != "stencil":
        reasons.append(f"the {cfg.solver} form")
    if collect_losses:
        reasons.append("loss trajectories")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        reasons.append("a gradient is wanted")
    return reasons


def resolve_graph_key(params: DiscParams, state: DiscState, cfg: DiscConfig) -> tuple:
    """Everything that changes a re-solve graph's captured work: the device,
    the lane count, the memory's and the filter's shapes and dtypes, and the
    schedule and the constants the solve bakes in."""
    m = state.memory
    return (m.samples.device, m.weights.shape[0],
            tuple((tuple(t.shape), t.dtype) for t in (m.samples, m.labels, m.pixel_weights,
                                                       m.weights, params.filter)),
            tuple(int(n) for n in cfg.update_iters),
            tuple(float(r) for r in cfg.filter_reg[1:]),
            tuple(float(p) for p in cfg.precond[1:]), float(cfg.direction_forget_factor))


def _take_due(due, new, old):
    """Per lane, `new` where the (N,) bool tensor `due` holds, else `old`."""
    return torch.where(lanes(due, new), new, old)


def _resolve_schedule(cfg: DiscConfig, x, M9, v, filt, p, r_prev, rho, have_p, step_alpha,
                      due):
    """What a re-solve graph captures: the stencil form's GN-CG schedule on
    the samples x and the stencil terms, from the filter and CG state given,
    then the `due` select. Returns the selected filter, p, r_prev, rho,
    have_p and step_alpha."""
    old = CGState(p=(p,), r_prev=(r_prev,), rho=rho, have_p=have_p, step_alpha=step_alpha)
    theta, cg = gauss_newton_cg_quadform(
        lambda f: _filter_net(f, x)[:, :, 0], (filt,), old, cfg.update_iters,
        scalar_preconditioner(tuple(float(q) for q in cfg.precond[1:])),
        cfg.direction_forget_factor, M9, v, cfg.filter_reg[1:])
    return tuple(_take_due(due, a, b) for a, b in (
        (theta[0], filt), (cg.p[0], p), (cg.r_prev[0], r_prev), (cg.rho, rho),
        (cg.have_p, have_p), (cg.step_alpha, step_alpha)))


def _replay_resolve(params: DiscParams, state: DiscState, due, cfg: DiscConfig):
    """(filter, CGState) of a re-solve that a CUDA graph served, each lane's
    where `due` holds (every lane's where it is None); None where the
    re-solve is to run eagerly."""
    if eager_reasons(params, state, cfg):
        return None
    m, cg = state.memory, state.cg

    def inputs():
        _, _, M9, v = _stencil_terms(m, tuple(m.samples.shape[-2:]))
        return (m.samples, M9, v, params.filter, cg.p[0], cg.r_prev[0], cg.rho, cg.have_p,
                cg.step_alpha, torch.ones_like(cg.have_p) if due is None else due)

    out = RESOLVE_GRAPHS.run(resolve_graph_key(params, state, cfg),
                             lambda *a: _resolve_schedule(cfg, *a), inputs)
    if out is None:
        return None
    filt, p, r_prev, rho, have_p, step_alpha = out
    return filt, replace(cg, p=(p,), r_prev=(r_prev,), rho=rho, have_p=have_p,
                         step_alpha=step_alpha)


def filter_resolve(params: DiscParams, state: DiscState, cfg: DiscConfig,
                   collect_losses: bool = False):
    """Filter-only re-solve of every lane on its current memory,
    warm-started from the carried CG state, replayed as a CUDA graph where
    `eager_reasons` allows. Returns (params, cg[, losses])."""
    if not collect_losses:
        got = _replay_resolve(params, state, None, cfg)
        if got is not None:
            return params._replace(filter=got[0]), got[1]
    return _filter_resolve_eager(params, state, cfg, collect_losses)


def _filter_resolve_eager(params: DiscParams, state: DiscState, cfg: DiscConfig,
                          collect_losses: bool = False):
    score_hw = tuple(state.memory.samples.shape[-2:])
    out = _solve(state.memory, cfg.filter_reg[1:], cfg.precond[1:], _filter_net,
                 (params.filter,), state.cg, cfg.update_iters, cfg, score_hw, collect_losses)
    return (params._replace(filter=out[0][0]),) + tuple(out[1:])


def disc_update(params: DiscParams, state: DiscState, compressed_sample, train_y,
                cfg: DiscConfig):
    """The host loop's per-frame online update of one object (N = 1): skip
    when the soft mask has < 10 foreground pixels, else insert into memory
    and re-solve every `train_skipping`-th frame.

    :param compressed_sample: (1, c, h, w) from disc_apply
    :param train_y: (1, 1, H, W) merged soft mask of this object
    """
    state.frame_num = [f + 1 for f in state.frame_num]
    if not cfg.update_filters:
        return params, state
    enough_fg = int((train_y > 0.5).sum()) >= 10      # the frame's one sync
    label, pw = online_update_weights(train_y, cfg)
    state.memory = memory_update(state.memory, compressed_sample, label, pw,
                                 cfg.learning_rate, enabled=enough_fg)
    if enough_fg and state.frame_num[0] % cfg.train_skipping == 0:
        params, state.cg = filter_resolve(params, state, cfg)
        state.n_resolves = state.n_resolves + 1
    return params, state


# -- the fused tracker's pieces: nothing read on the host ------------------


def project_all(features, project):
    """Every object's projection of every frame in one 1x1 convolution.

    :param features: (T, Cin, h, w)
    :param project: (N, c, Cin, 1, 1)
    :return: (T, N, c, h, w)
    """
    out = conv2d(features, project.flatten(0, 1))
    return out.view(features.shape[0], project.shape[0], -1, *features.shape[-2:])


def classify_objects(compressed, filters, clamp_output: bool = False):
    """N filters on N projected maps (lane_filter); clamp_output bounds the
    scores to (-0.1, 1.2).

    :param compressed: (B, N, c, h, w)
    :param filters: (N, out, c, 3, 3)
    :return: (B, N * out, h, w) coarse scores
    """
    B, N, c, h, w = compressed.shape
    if filters.dim() != 5 or filters.shape[0] != N or filters.shape[2] != c:
        raise ValueError(f"classify_objects: filters {tuple(filters.shape)} for "
                         f"{N} objects of {c} channels")
    scores = lane_filter(compressed.transpose(0, 1), filters).transpose(0, 1)
    scores = scores.reshape(B, -1, h, w)
    return scores.clamp(*CLAMP) if clamp_output else scores


def insert_sample(state: DiscState, compressed, train_y, enabled, active, cfg: DiscConfig):
    """One tracked frame of N objects: the memory inserts, gated at the rows
    by the (N,) bool tensor `enabled` (tracked and >= 10 foreground pixels),
    and the frame counters, which advance on the lanes that `active` (N host
    bools) marks as tracked, whatever their masks hold.

    :param compressed: (N, c, h, w); train_y: (N, 1, H, W)
    """
    label, pw = online_update_weights(train_y, cfg)
    state.memory = memory_update(state.memory, compressed, label, pw,
                                 cfg.learning_rate, enabled=enabled)
    state.frame_num = [f + bool(a) for f, a in zip(state.frame_num, active)]


def resolve_due(params: DiscParams, state: DiscState, due, cfg: DiscConfig) -> DiscParams:
    """One filter re-solve of every lane, whose result each lane takes where
    the (N,) bool tensor `due` holds: only the filters and the CG state pass
    through the select, the memory buffers are read by the solve and never
    copied. Replayed as a CUDA graph where `eager_reasons` allows; the
    counter `resolve_replays` adds 1 for a call a replay served, 0 for one
    run eagerly."""
    got = _replay_resolve(params, state, due, cfg)
    profiling.count("resolve_replays", int(got is not None))
    if got is not None:
        filt, state.cg = got
    else:
        new_params, new_cg = _filter_resolve_eager(params, state, cfg)
        sel = partial(_take_due, due)
        cg = state.cg
        state.cg = replace(cg, p=tuple(map(sel, new_cg.p, cg.p)),
                           r_prev=tuple(map(sel, new_cg.r_prev, cg.r_prev)),
                           rho=sel(new_cg.rho, cg.rho), have_p=sel(new_cg.have_p, cg.have_p),
                           step_alpha=sel(new_cg.step_alpha, cg.step_alpha))
        filt = sel(new_params.filter, params.filter)
    state.n_resolves = state.n_resolves + due.long()
    return params._replace(filter=filt)
