"""The host-loop tracker (frtm_tpu/runtime/tracker.py): per-object target
models initialised at their start frames, then per frame classify -> refine
-> soft multi-object merge -> per-object online update. Single-layer target
model, float32.

Two additions over the JAX Tracker: `disc_params0` (the target model's
starting weights; by default the port's own seeded init — the JAX tracker
draws them from jax.random.PRNGKey(0), which torch cannot reproduce) and
`augmenter` (any object with `augment_first_frame(image, mask, rng)`
returning (K, 3, H, W) / (K, 1, H, W) uint8 tensors on the tracker's device).
With `profile=True` each phase ends in a device synchronise and its seconds
accumulate in `phase_seconds`.
"""
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..config import TrackerConfig
from ..device import resolve_device
from ..models.augmenter import ImageAugmenter
from ..models.discriminator import (DiscParams, DiscState, disc_apply, disc_init,
                                    disc_update, init_disc_params)
from ..models.resnet import ResNet
from ..models.seg_network import SegNetwork, seg_network_apply


@dataclass
class TargetObject:
    object_id: int
    index: int              # row in the mask stack (background = 0)
    start_frame: int
    start_mask: torch.Tensor  # (H, W) float 0/1
    params: DiscParams
    state: DiscState
    current_sample: Optional[torch.Tensor] = None


def merge_soft_masks(masks: torch.Tensor) -> torch.Tensor:
    """Soft aggregation + mutual exclusion; masks (n_obj+1, H, W), row 0 is
    background. One object: the 2-way softmax over odds is the sigmoid of
    the odds difference; ties (p == 0.5) go to background."""
    if masks.shape[0] == 2:
        p = masks[1].clamp(1e-7, 1 - 1e-7)
        r1 = p / (1.0 - p)
        r0 = (1.0 - p) / p
        win = (r1 > r0).to(masks.dtype)
        s1 = torch.sigmoid(r1 - r0)
        s0 = torch.sigmoid(r0 - r1)
        return torch.stack([s0 * (1.0 - win), s1 * win])
    p = masks.clamp(1e-7, 1 - 1e-7)
    p = torch.cat([(1.0 - p[1:]).amin(dim=0, keepdim=True), p[1:]])
    segs = torch.softmax(p / (1.0 - p), dim=0)
    onehot = torch.zeros_like(segs).scatter_(0, segs.argmax(dim=0, keepdim=True), 1.0)
    return segs * onehot


def masks_to_labels(masks: torch.Tensor, object_ids: torch.Tensor) -> torch.Tensor:
    """Exclusive soft masks -> label image (the same aggregation)."""
    if object_ids.shape[0] == 2:
        return torch.where(masks[1] > 0.5, object_ids[1], object_ids[0])
    p = masks.clamp(1e-7, 1 - 1e-7)
    p = torch.cat([(1.0 - p[1:]).amin(dim=0, keepdim=True), p[1:]])
    idx = torch.softmax(p / (1.0 - p), dim=0).argmax(dim=0)
    return object_ids[idx]


class Tracker:

    def __init__(self, cfg: TrackerConfig, backbone: ResNet, refiner: SegNetwork,
                 device=None, disc_params0: Optional[DiscParams] = None,
                 augmenter=None, profile: bool = False):
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("the port's tracker computes in float32")
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.disc_cfg = cfg.disc
        self.backbone = backbone.to(dev).eval()
        self.refiner = refiner.to(dev).eval()
        self.augmenter = augmenter or ImageAugmenter(cfg.aug_params, dev)
        if disc_params0 is None:
            disc_params0 = init_disc_params(cfg.disc, torch.Generator().manual_seed(0), dev)
        self.disc_params0 = DiscParams(*(t.to(dev) for t in disc_params0))
        self._all_layers = tuple(sorted(set(cfg.refnet_layers) | {cfg.disc.layer},
                                        reverse=True))
        self.profile = profile
        self.phase_seconds = defaultdict(float)
        self.clear()

    def clear(self):
        self.targets: Dict[int, TargetObject] = {}
        self.current_frame = 0
        self.current_masks: Optional[torch.Tensor] = None

    @contextmanager
    def _phase(self, name):
        if not self.profile:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phase_seconds[name] += time.perf_counter() - t0

    @torch.no_grad()
    def initialize(self, image: np.ndarray, labels: np.ndarray, new_objects):
        """Create and solve a target model per new object."""
        H, W = image.shape[:2]
        n_rows = len(self.targets) + len(new_objects) + 1
        self.current_masks = torch.zeros((n_rows, H, W), device=self.device)
        for obj_id in new_objects:
            mask = (np.asarray(labels).squeeze() == obj_id).astype(np.float32)
            rng = np.random.RandomState(0)  # per-object reseed, as the reference
            with self._phase("augment"):
                im_aug, lb_aug = self.augmenter.augment_first_frame(image, mask[..., None], rng)
            with self._phase("init_solve"):
                ft = self.backbone.extract_features(im_aug, output_layers=[self.disc_cfg.layer])
                params, state = disc_init(self.disc_params0, ft[self.disc_cfg.layer], lb_aug,
                                          self.disc_cfg)
            start_mask = torch.from_numpy(mask).to(self.device)
            t = TargetObject(object_id=obj_id, index=len(self.targets) + 1,
                             start_frame=self.current_frame, start_mask=start_mask,
                             params=params, state=state)
            self.targets[obj_id] = t
            self.current_masks[t.index] = start_mask

    @torch.no_grad()
    def track(self, image: np.ndarray) -> torch.Tensor:
        """Classify, refine, merge, update; returns the merged soft masks."""
        im_size = image.shape[:2]
        with self._phase("extract"):
            im = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
            features = self.backbone.extract_features(im.permute(2, 0, 1)[None],
                                                      output_layers=self._all_layers)
        tracked = [t for t in self.targets.values() if t.start_frame < self.current_frame]
        fresh = [t for t in self.targets.values() if t.start_frame == self.current_frame]

        with self._phase("classify_decode"):
            for t in tracked:
                scores, cft = disc_apply(t.params, features[self.disc_cfg.layer])
                logits = seg_network_apply(self.refiner, scores,
                                           {L: features[L] for L in self.cfg.refnet_layers},
                                           im_size, layers=self.cfg.refnet_layers)
                t.current_sample = cft[0]
                self.current_masks[t.index] = torch.sigmoid(logits[0, 0])

        with self._phase("merge"):
            for t_new in fresh:
                for t_old in tracked:
                    self.current_masks[t_old.index] *= 1.0 - t_new.start_mask
            self.current_masks = merge_soft_masks(self.current_masks)

        with self._phase("update"):
            for t in tracked:
                t.params, t.state = disc_update(t.params, t.state, t.current_sample,
                                                self.current_masks[t.index][None],
                                                self.disc_cfg)
        return self.current_masks

    def run_sequence(self, sequence):
        """Track one sequence; returns (list of (H, W) uint8 label images, fps)."""
        self.clear()
        ids = torch.tensor([0] + list(sequence.obj_ids), dtype=torch.int32,
                           device=self.device)
        outputs = []
        t0 = time.perf_counter()
        for i in range(len(sequence)):
            image, labels, new_objects = sequence[i]
            old_objects = list(self.targets)
            if new_objects:
                self.initialize(image, labels, new_objects)
            if old_objects:
                out = masks_to_labels(self.track(image), ids)
            elif new_objects:
                out = torch.from_numpy(np.asarray(labels).squeeze().astype(np.uint8))
            else:
                out = torch.zeros(image.shape[:2], dtype=torch.uint8)
            outputs.append(out)
            self.current_frame += 1
        outputs = [o.cpu().numpy().astype(np.uint8) for o in outputs]
        fps = len(sequence) / max(time.perf_counter() - t0, 1e-9)
        return outputs, fps
