"""Fixed-capacity sample memory with decaying sample weights
(frtm_tpu/models/memory.py): K init slots with the real first frame
double-weighted, then per-frame replacement at the minimum-weight slot with
learning-rate decay and renormalisation. Empty slots keep weight 0 and drop
out of the least-squares problem.

The memory is stored for N objects at once, as the JAX package's `jax.vmap`
over objects holds it: every store has a leading object axis, and each lane
picks, replaces and reweights its own slots.

Unlike the JAX version, `memory_update` writes the inserted rows IN PLACE
(the label store is (N, capacity, 1, H, W) float32 — 131 MB per object at
80 x 480 x 854 — and a functional copy per frame would double the traffic).
The `enabled` gate is a host bool, or an (N,) bool tensor that is never read
on the host: the gating then happens at the inserted rows and the small
weight vectors, as in the JAX version. Slots are addressed with index
tensors throughout, so an insert makes no device-to-host read.
"""
from dataclasses import dataclass

import torch


@dataclass
class MemoryState:
    samples: torch.Tensor        # (N, cap, C, h, w) feature maps
    labels: torch.Tensor         # (N, cap, 1, H, W) soft masks
    pixel_weights: torch.Tensor  # (N, cap, 1, H, W)
    weights: torch.Tensor        # (N, cap) sample weights (0 = empty slot)
    current_size: torch.Tensor   # (N,) int64 on the device
    prev_ind: torch.Tensor       # (N,) int64 on the device, -1 = none yet


def memory_init(capacity: int, features, labels, pixel_weights) -> MemoryState:
    """Fill the first K slots of each lane; slot 0 (the real frame) gets
    twice the weight before renormalising. The stores are allocated with
    their object axis, so no lane is copied again to stack them.

    :param features: (N, K, C, h, w); labels, pixel_weights: (N, K, 1, H, W)
    """
    N, K = features.shape[:2]
    if K > capacity:
        raise ValueError(f"{K} samples do not fit a memory of {capacity}")
    dev = features.device
    samples = features.new_zeros((N, capacity) + tuple(features.shape[2:]))
    samples[:, :K] = features
    lab = torch.zeros((N, capacity) + tuple(labels.shape[2:]), dtype=torch.float32, device=dev)
    lab[:, :K] = labels.float()
    pw = torch.zeros_like(lab)
    pw[:, :K] = pixel_weights
    wts = torch.zeros((N, capacity), dtype=torch.float32, device=dev)
    wts[:, :K] = 1.0 / K
    wts[:, 0] = 2.0 / K
    wts[:, :K] = wts[:, :K] / wts[:, :K].sum(dim=1, keepdim=True)
    return MemoryState(samples, lab, pw, wts,
                       torch.full((N,), K, dtype=torch.int64, device=dev),
                       torch.full((N,), -1, dtype=torch.int64, device=dev))


def memory_update(state: MemoryState, feature, label, pixel_weight,
                  learning_rate: float, enabled=True) -> MemoryState:
    """Insert one sample per lane at that lane's min-weight slot; decay and
    renormalise. `feature` (N, C, h, w), `label` and `pixel_weight`
    (N, 1, H, W); `enabled`: a bool, or an (N,) bool tensor (a False lane
    keeps its values)."""
    if enabled is False:
        return state
    sw = state.weights
    N = sw.shape[0]
    lr = learning_rate
    slot0 = torch.zeros((N, 1), dtype=torch.int64, device=sw.device)
    # degenerate: everything on slot 0 (and lr == 1 would divide by 0)
    sw_degen = torch.zeros_like(sw).scatter_(1, slot0, 1.0)
    if lr >= 1.0:
        sw_new, r_ind = sw_degen, slot0
    else:
        r_ind = torch.argmin(sw, dim=1, keepdim=True)
        sw_first = (sw / (1.0 - lr)).scatter_(1, r_ind, lr)
        prev = state.prev_ind.clamp_min(0)[:, None]
        sw_chain = sw.scatter(1, r_ind, sw.gather(1, prev) / (1.0 - lr))
        sw_new = torch.where(state.prev_ind[:, None] < 0, sw_first, sw_chain)
        empty = (state.current_size == 0)[:, None]
        sw_new = torch.where(empty, sw_degen, sw_new)
        r_ind = torch.where(empty, slot0, r_ind)
    sw_new = sw_new / sw_new.sum(dim=1, keepdim=True)
    new_size = torch.clamp_max(state.current_size + 1, state.samples.shape[1])
    r_ind = r_ind[:, 0]
    lane = torch.arange(N, device=sw.device)

    rows = [(state.samples, feature), (state.labels, label.float()),
            (state.pixel_weights, pixel_weight)]
    if enabled is not True:
        rows = [(store, torch.where(enabled.reshape((N,) + (1,) * (row.dim() - 1)),
                                    row, store[lane, r_ind]))
                for store, row in rows]
        sw_new = torch.where(enabled[:, None], sw_new, sw)
        new_size = torch.where(enabled, new_size, state.current_size)
        r_prev = torch.where(enabled, r_ind, state.prev_ind)
    else:
        r_prev = r_ind
    for store, row in rows:
        store.index_put_((lane, r_ind), row)
    state.weights = sw_new
    state.current_size = new_size
    state.prev_ind = r_prev
    return state
