"""The host-loop tracker (frtm_tpu/runtime/tracker.py): per-object target
models initialised at their start frames, then per frame classify -> refine
-> soft multi-object merge -> per-object online update. The target model is
single-layer, or with cfg.disc_layers one model per named layer
(models/multilayer.py), whose score maps the decoder concatenates. With
cfg.compute_dtype = "bfloat16" the backbone computes in bfloat16
and emits float32 features, in `track` and at init alike; the decoder, the
target model and the merge stay float32, as in the JAX Tracker, which hands
its float32 refiner those features.

Two additions over the JAX Tracker: `disc_params0` (the target model's
starting weights, {layer: DiscParams} for multilayer models; by default the
port's own seeded init — the JAX tracker draws them from
jax.random.PRNGKey(0), which torch cannot reproduce) and
`augmenter` (any object with `augment_first_frame(image, mask, rng)`
returning (K, 3, H, W) / (K, 1, H, W) uint8 tensors on the tracker's device).
With `profile=True` each phase starts and ends in a device synchronise
(utils/profiling.py); its seconds accumulate in `phase_seconds`.
"""
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import TrackerConfig, compute_dtype_of
from ..data.image import LabelWriter, imwrite_indexed
from ..device import resolve_device
from ..models.augmenter import ImageAugmenter
from ..models.discriminator import (DiscParams, DiscState, disc_apply, disc_init,
                                    disc_update, init_disc_params, repeat_params)
from ..models.multilayer import (layer_configs, ml_disc_apply, ml_disc_init, ml_disc_update,
                                 starting_params)
from ..models.resnet import ResNet
from ..models.seg_network import SegNetwork, seg_network_apply
from ..ops.conv import compute_copy
from ..utils.meters import AverageMeter
from ..utils.profiling import PhaseTimer


@dataclass
class TargetObject:
    object_id: int
    index: int              # row in the mask stack (background = 0)
    start_frame: int
    start_mask: torch.Tensor  # (H, W) float 0/1
    params: DiscParams      # one lane; {layer: DiscParams} with multilayer models
    state: DiscState        # one lane; {layer: DiscState} with multilayer models
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
        self.dtype = compute_dtype_of(cfg)
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.disc_cfg = cfg.disc
        self.backbone = backbone.to(dev).eval()
        self.backbone_c = compute_copy(self.backbone, self.dtype)   # made once
        self.refiner = refiner.to(dev).eval()
        self.augmenter = augmenter or ImageAugmenter(cfg.aug_params, dev)
        self.multilayer = bool(cfg.disc_layers)
        self.disc_cfgs = layer_configs(cfg)
        self.disc_params0 = starting_params(cfg, self.disc_cfgs, disc_params0, dev,
                                            init_disc_params)
        self._all_layers = tuple(sorted(set(cfg.refnet_layers) | set(self.disc_cfgs),
                                        reverse=True))
        self.profile = profile
        self.timer = PhaseTimer(sync=profile, device=dev)
        self._phase = self.timer.phase
        self.phase_seconds = self.timer.totals
        self.clear()

    def clear(self):
        self.targets: Dict[int, TargetObject] = {}
        self.current_frame = 0
        self.current_masks: Optional[torch.Tensor] = None

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
                ft = self.backbone_c.extract_features(im_aug, output_layers=list(self.disc_cfgs))
                # one object: the batched init with N = 1
                if self.multilayer:
                    params, state = ml_disc_init(
                        {L: repeat_params(p, 1) for L, p in self.disc_params0.items()},
                        {L: f[None] for L, f in ft.items()}, lb_aug[None], self.disc_cfgs)
                else:
                    params, state = disc_init(repeat_params(self.disc_params0, 1),
                                              ft[self.disc_cfg.layer][None], lb_aug[None],
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
            features = self.backbone_c.extract_features(im.permute(2, 0, 1)[None],
                                                        output_layers=self._all_layers)
        tracked = [t for t in self.targets.values() if t.start_frame < self.current_frame]
        fresh = [t for t in self.targets.values() if t.start_frame == self.current_frame]

        with self._phase("classify_decode"):
            for t in tracked:
                if self.multilayer:
                    scores, cfts = ml_disc_apply(t.params, features, self.disc_cfgs)
                    t.current_sample = {L: c[0] for L, c in cfts.items()}
                else:
                    scores, cft = disc_apply(t.params, features[self.disc_cfg.layer],
                                             clamp_output=self.disc_cfg.clamp_output)
                    t.current_sample = cft[0]
                logits = seg_network_apply(self.refiner, scores,
                                           {L: features[L] for L in self.cfg.refnet_layers},
                                           im_size, layers=self.cfg.refnet_layers)
                self.current_masks[t.index] = torch.sigmoid(logits[0, 0])

        with self._phase("merge"):
            for t_new in fresh:
                for t_old in tracked:
                    self.current_masks[t_old.index] *= 1.0 - t_new.start_mask
            self.current_masks = merge_soft_masks(self.current_masks)

        with self._phase("update"):
            update = ml_disc_update if self.multilayer else disc_update
            cfg = self.disc_cfgs if self.multilayer else self.disc_cfg
            for t in tracked:
                t.params, t.state = update(t.params, t.state, t.current_sample,
                                           self.current_masks[t.index][None, None], cfg)
        return self.current_masks

    def run_sequence(self, sequence, speedrun: bool = False):
        """Track one sequence; returns (list of (H, W) uint8 label images,
        fps). speedrun: first an untimed init and one tracked step on frame
        0 (the convolution algorithm search, first launches)."""
        self.clear()
        ids = torch.tensor([0] + list(sequence.obj_ids), dtype=torch.int32,
                           device=self.device)
        if speedrun:
            image, labels, new_objects = sequence[0]
            if new_objects:
                self.initialize(image, labels, new_objects)
                self.current_frame = 1
                self.track(image)
            self.clear()
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

    def run_dataset(self, dataset, out_path, speedrun=False, restart=None):
        """Track every sequence, write indexed PNGs under
        out_path/<sequence>/ (a LabelWriter's threads, while the next
        sequence tracks; all written when this returns), report the average
        fps. `restart`: skip the sequences before the one of that name."""
        out_path = Path(out_path)
        out_path.mkdir(exist_ok=True, parents=True)
        fps_meter = AverageMeter()
        print("Evaluating", dataset.name)
        restarted = restart is None
        # each sequence's PNGs are written while the next one tracks; the
        # writer looks imwrite_indexed up here at each call
        with LabelWriter(lambda path, labels: imwrite_indexed(path, labels)) as writer:
            for sequence in dataset:
                if not restarted:
                    if sequence.name != restart:
                        continue
                    restarted = True
                if hasattr(sequence, "preload"):
                    sequence.preload()
                outputs, seq_fps = self.run_sequence(sequence, speedrun)
                fps_meter.update(seq_fps)
                print(f"{sequence.name}: {seq_fps:.2f} fps")
                dst = out_path / sequence.name
                dst.mkdir(exist_ok=True)
                writer.put(dst, outputs, sequence.frame_names)
        print("Average frame rate: %.2f fps" % fps_meter.avg)
        return fps_meter.avg
