"""Fixed-capacity sample memory with decaying sample weights
(frtm_tpu/models/memory.py): K init slots with the real first frame
double-weighted, then per-frame replacement at the minimum-weight slot with
learning-rate decay and renormalisation. Empty slots keep weight 0 and drop
out of the least-squares problem.

Unlike the JAX version, `memory_update` writes the inserted row IN PLACE
(the label store is (capacity, 1, H, W) float32 — 131 MB at 80 x 480 x 854 —
and a functional copy per frame would double the traffic). The `enabled`
gate is a host bool read once per frame by the caller.
"""
from dataclasses import dataclass

import torch


@dataclass
class MemoryState:
    samples: torch.Tensor        # (cap, C, h, w) feature maps
    labels: torch.Tensor         # (cap, 1, H, W) soft masks
    pixel_weights: torch.Tensor  # (cap, 1, H, W)
    weights: torch.Tensor        # (cap,) sample weights (0 = empty slot)
    current_size: int
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
    return MemoryState(samples, lab, pw, wts, K,
                       torch.tensor(-1, dtype=torch.int64, device=dev))


def memory_update(state: MemoryState, feature, label, pixel_weight,
                  learning_rate: float, enabled: bool = True) -> MemoryState:
    """Insert one sample at the min-weight slot; decay and renormalise."""
    if not enabled:
        return state
    sw = state.weights
    lr = learning_rate
    if state.current_size == 0 or lr >= 1.0:
        # degenerate: everything on slot 0 (and lr == 1 would divide by 0)
        sw_new = torch.zeros_like(sw)
        sw_new[0] = 1.0
        r_ind = torch.zeros((), dtype=torch.int64, device=sw.device)
    else:
        r_ind = torch.argmin(sw)
        sw_first = sw / (1.0 - lr)
        sw_first[r_ind] = lr
        sw_chain = sw.clone()
        sw_chain[r_ind] = sw[state.prev_ind] / (1.0 - lr)
        sw_new = torch.where(state.prev_ind < 0, sw_first, sw_chain)
    sw_new = sw_new / sw_new.sum()

    state.samples[r_ind] = feature
    state.labels[r_ind] = label.float()
    state.pixel_weights[r_ind] = pixel_weight
    state.weights = sw_new
    state.current_size = min(state.current_size + 1, state.samples.shape[0])
    state.prev_ind = r_ind
    return state
