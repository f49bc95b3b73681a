"""Fixed-capacity sample memory with decaying sample weights
(frtm_tpu/models/memory.py): K init slots with the real first frame
double-weighted, then per-frame replacement at the minimum-weight slot with
learning-rate decay and renormalisation. Empty slots keep weight 0 and drop
out of the least-squares problem.

Unlike the JAX version, `memory_update` writes the inserted row IN PLACE
(the label store is (capacity, 1, H, W) float32 — 131 MB at 80 x 480 x 854 —
and a functional copy per frame would double the traffic). The `enabled`
gate is a host bool, or a 0-dim bool tensor that is never read on the host:
the gating then happens at the inserted row and the small weight vector, as
in the JAX version. Slots are addressed with index tensors throughout, so an
insert makes no device-to-host read.
"""
from dataclasses import dataclass

import torch


@dataclass
class MemoryState:
    samples: torch.Tensor        # (cap, C, h, w) feature maps
    labels: torch.Tensor         # (cap, 1, H, W) soft masks
    pixel_weights: torch.Tensor  # (cap, 1, H, W)
    weights: torch.Tensor        # (cap,) sample weights (0 = empty slot)
    current_size: torch.Tensor   # int64 scalar on the device
    prev_ind: torch.Tensor       # int64 scalar on the device, -1 = none yet


def memory_init(capacity: int, features, labels, pixel_weights) -> MemoryState:
    """Fill the first K slots; slot 0 (the real frame) gets twice the weight
    before renormalising."""
    K = features.shape[0]
    if K > capacity:
        raise ValueError(f"{K} samples do not fit a memory of {capacity}")
    dev = features.device
    samples = features.new_zeros((capacity,) + tuple(features.shape[1:]))
    samples[:K] = features
    lab = torch.zeros((capacity,) + tuple(labels.shape[1:]), dtype=torch.float32, device=dev)
    lab[:K] = labels.float()
    pw = torch.zeros_like(lab)
    pw[:K] = pixel_weights
    wts = torch.zeros(capacity, dtype=torch.float32, device=dev)
    wts[:K] = 1.0 / K
    wts[0] = 2.0 / K
    wts[:K] = wts[:K] / wts[:K].sum()
    return MemoryState(samples, lab, pw, wts,
                       torch.full((), K, dtype=torch.int64, device=dev),
                       torch.full((), -1, dtype=torch.int64, device=dev))


def memory_update(state: MemoryState, feature, label, pixel_weight,
                  learning_rate: float, enabled=True) -> MemoryState:
    """Insert one sample at the min-weight slot; decay and renormalise.
    `enabled`: a bool, or a 0-dim bool tensor (False leaves the state's
    values unchanged)."""
    if enabled is False:
        return state
    sw = state.weights
    lr = learning_rate
    slot0 = torch.zeros(1, dtype=torch.int64, device=sw.device)
    # degenerate: everything on slot 0 (and lr == 1 would divide by 0)
    sw_degen = torch.zeros_like(sw).index_fill_(0, slot0, 1.0)
    if lr >= 1.0:
        sw_new, r_ind = sw_degen, slot0
    else:
        r_ind = torch.argmin(sw).reshape(1)
        sw_first = (sw / (1.0 - lr)).index_fill_(0, r_ind, lr)
        prev = state.prev_ind.clamp_min(0).reshape(1)
        sw_chain = sw.index_copy(0, r_ind, sw.index_select(0, prev) / (1.0 - lr))
        sw_new = torch.where(state.prev_ind < 0, sw_first, sw_chain)
        empty = state.current_size == 0
        sw_new = torch.where(empty, sw_degen, sw_new)
        r_ind = torch.where(empty, slot0, r_ind)
    sw_new = sw_new / sw_new.sum()
    new_size = torch.clamp_max(state.current_size + 1, state.samples.shape[0])

    rows = [(state.samples, feature), (state.labels, label.float()),
            (state.pixel_weights, pixel_weight)]
    if enabled is not True:
        rows = [(store, torch.where(enabled, row, store.index_select(0, r_ind)[0]))
                for store, row in rows]
        sw_new = torch.where(enabled, sw_new, sw)
        new_size = torch.where(enabled, new_size, state.current_size)
        r_prev = torch.where(enabled, r_ind[0], state.prev_ind)
    else:
        r_prev = r_ind[0]
    for store, row in rows:
        store.index_copy_(0, r_ind, row[None])
    state.weights = sw_new
    state.current_size = new_size
    state.prev_ind = r_prev
    return state
