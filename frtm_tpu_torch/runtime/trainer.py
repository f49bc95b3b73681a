"""Offline refiner training (frtm_tpu/runtime/trainer.py).

Only the refiner is trained. Per sample a frozen target model is solved by
GN-CG on the augmented first frame (or read from the target-model cache);
the train step then runs the frozen backbone, each sample's own target model
and the decoder with batch-statistics BatchNorm over the sample's train
frames, and minimises the clamped-sigmoid BCE with the JAX package's
optimizer chain: L2 decay 1e-5 added to the gradient, then AMSGrad in optax's
order of operations (`AMSGrad`, not torch.optim.Adam(amsgrad=True), which
keeps the maximum of the raw second moment and so takes other steps), the
learning rate set per epoch by StepLR(127, 0.1).

The decoder's kernels 1 and 2 run forward and backward on the card
(ops/kernels: the backward kernels are the gradient the JAX package takes by
autodiff of its XLA decoder). Everything before the decoder runs under
`torch.no_grad`.

`Trainer(mesh=...)` trains data-parallel over the mesh's processes, one per
card (parallel/train_step.py): each process materialises only its rows of
every global batch, solves their target models, and takes the step with the
BatchNorm statistics and the gradients all-reduced; only rank 0 writes
checkpoints and statistics.

What the JAX trainer has and this one does not: the power-of-two bucket of
cache misses, which only bounds the number of XLA programs. A batch's misses
are solved together here, as the JAX trainer's vmapped program solves them:
one `disc_init` (the one the tracker runs) with a lane per miss.
"""
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TrackerConfig
from ..data.training_datasets import SampleSpec
from ..device import resolve_device
from ..models.augmenter import ImageAugmenter
from ..models.discriminator import DiscParams, disc_init, init_disc_params, repeat_params
from ..models.resnet import ResNet
from ..models.seg_network import SegNetwork, apply_bn_updates, seg_network_apply
from ..ops.collectives import all_reduce_grads, all_reduce_sum
from ..parallel.distributed import barrier, batch_rows, process_count, process_index
from ..parallel.mesh import replicated
from ..utils.convert import disc_params_from_jax, disc_params_to_jax
from ..utils.meters import AverageMeter
from ..utils.prefetch import prefetch_iter
from ..utils.profiling import PhaseTimer

def iou_accuracy(pred, gt):
    """IoU per sample of (B, H, W) maps in [0, 1], thresholded at 0.5, with
    the reference's conventions: an infinite ratio reads 0, 0 / 0 reads 1."""
    pred = (pred > 0.5).float()
    gt = (gt > 0.5).float()
    i = (pred * gt).sum(dim=(-2, -1))
    u = ((pred + gt) > 0.5).float().sum(dim=(-2, -1))
    iou = i / u
    iou = torch.where(torch.isinf(iou), torch.zeros_like(iou), iou)
    return torch.where(torch.isnan(iou), torch.ones_like(iou), iou)


class AMSGrad:
    """The JAX package's make_optimizer chain on a list of parameters:
    g += weight_decay * p; mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu;
    nu_max = max(nu_max, nu / (1 - b2^t)); p -= lr * (mu / (1 - b1^t)) /
    (sqrt(nu_max) + eps). Every operation in float32 and in optax's order.
    Only parameters are given to it; BatchNorm running statistics are
    buffers and are left out, as the JAX mask leaves them out of the decay."""

    def __init__(self, params, weight_decay=1e-5, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float):
        """One update from the parameters' .grad; lr is taken as float32."""
        self.count += 1
        dev = self.params[0].device
        count = torch.tensor(float(self.count), dtype=torch.float32, device=dev)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** count
        neg_lr = -torch.tensor(lr, dtype=torch.float32, device=dev)
        for p, mu, nu, nu_max in zip(self.params, self.mu, self.nu, self.nu_max):
            g = p.grad + self.weight_decay * p
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            torch.maximum(nu_max, nu / bc2, out=nu_max)
            p.add_((mu / bc1) / (torch.sqrt(nu_max) + self.eps) * neg_lr)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_dict(self):
        return {"count": self.count, "mu": [t.clone() for t in self.mu],
                "nu": [t.clone() for t in self.nu], "nu_max": [t.clone() for t in self.nu_max]}

    def load_state_dict(self, sd):
        if len(sd["mu"]) != len(self.params):
            raise ValueError(f"optimizer state for {len(sd['mu'])} parameters, "
                             f"this optimizer has {len(self.params)}")
        self.count = int(sd["count"])
        for key in ("mu", "nu", "nu_max"):
            for dst, src in zip(getattr(self, key), sd[key]):
                dst.copy_(src)


class TModelCache:
    """Target-model cache: one `.npz` per (sequence, first frame, object,
    layer), `{seq}/{frame0:05d}.{obj}.{layer}.npz`, holding `project`
    (1, 1, Cin, c) and `filter` (3, 3, c, 1) in the JAX package's HWIO
    layout, so that either package reads the other's cache. Corrupt files
    read as misses. A file is written under a temporary name in its
    directory and renamed into place, so that processes solving the same
    target model never leave, or read, a partly written file."""

    def __init__(self, path, enable=True, read_only=False):
        self.path = Path(path) if path else None
        self.enable = enable and path is not None
        self.read_only = read_only

    def _fname(self, spec: SampleSpec, layer):
        return self.path / spec.seq_name / ("%05d.%d.%s.npz" % (spec.frame0_id, spec.obj_id, layer))

    def load(self, spec, layer, device=None):
        if not self.enable:
            return None
        f = self._fname(spec, layer)
        if not f.exists():
            return None
        try:
            with np.load(f) as z:
                p = disc_params_from_jax(z["project"], z["filter"])
        except Exception as e:  # a corrupt file is a miss, as in the reference
            print(f"Could not read {f}: {e}")
            return None
        return DiscParams(p.project.to(device), p.filter.to(device))

    def save(self, spec, layer, params: DiscParams):
        if not self.enable or self.read_only:
            return
        f = self._fname(spec, layer)
        f.parent.mkdir(exist_ok=True, parents=True)
        project, filt = disc_params_to_jax(params)
        fd, tmp = tempfile.mkstemp(prefix=f".{f.name}.", suffix=".tmp", dir=f.parent)
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, project=project, filter=filt)
            os.replace(tmp, f)
        except BaseException:
            os.unlink(tmp)
            raise


def classify_per_sample(disc_batch: DiscParams, ft):
    """Each sample's scores under its own target model: ft (B, Cin, h, w),
    project (B, c, Cin, 1, 1), filter (B, out, c, 3, 3) -> (B, out, h, w),
    as two grouped convolutions."""
    B, cin, h, w = ft.shape
    c, out = disc_batch.project.shape[1], disc_batch.filter.shape[1]
    cft = F.conv2d(ft.reshape(1, B * cin, h, w), disc_batch.project.reshape(B * c, cin, 1, 1),
                   groups=B)
    s = F.conv2d(cft, disc_batch.filter.reshape(B * out, c, 3, 3), padding=1, groups=B)
    return s.reshape(B, out, h, w)


class TrainerModel:
    """Builds per-sample target models and computes the refiner's train step.

    :param disc_params0: the target model's starting weights (by default the
        port's seeded init; the JAX trainer draws them from PRNGKey(0), which
        torch cannot reproduce)
    :param profile: synchronise the card at every phase edge, so that
        `timer` holds each phase's device time (augment, extract, disc_init,
        forward, backward, step)
    """

    def __init__(self, cfg: TrackerConfig, backbone: ResNet, refiner: SegNetwork,
                 tmodel_cache: TModelCache, device=None, disc_params0=None,
                 profile: bool = False):
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.disc_cfg = cfg.disc
        self.backbone = backbone.to(dev).eval()
        self.refiner = refiner.to(dev)
        self.cache = tmodel_cache
        self.augmenter = ImageAugmenter(cfg.aug_params, dev)
        self.disc_params0 = disc_params0 if disc_params0 is not None else init_disc_params(
            cfg.disc, torch.Generator().manual_seed(0), dev)
        self._all_layers = tuple(sorted(set(cfg.refnet_layers) | {cfg.disc.layer}, reverse=True))
        self.timer = PhaseTimer(sync=profile, device=dev)

    @torch.no_grad()
    def build_disc_batch(self, first_images, first_labels, specs):
        """Per sample: a cache hit, or a miss that is augmented (each with
        np.random.RandomState(0)), extracted and solved, then saved. All the
        misses' augmented frames go through the backbone together, in chunks
        of 32, and all unique misses are solved together, one lane each, in
        one disc_init; a duplicate in the batch counts as a hit. Returns
        (DiscParams stacked over the batch, hits)."""
        L = self.disc_cfg.layer
        params = [None] * len(specs)
        hits = 0
        unique_misses = {}   # (seq, frame0, obj) -> [batch indices]
        for i, spec in enumerate(specs):
            cached = self.cache.load(spec, L, self.device)
            if cached is not None:
                params[i] = cached
                hits += 1
                continue
            key = (spec.seq_name, spec.frame0_id, spec.obj_id)
            if key in unique_misses:
                hits += 1
            unique_misses.setdefault(key, []).append(i)
        if unique_misses:
            keys = list(unique_misses)
            ims, lbs = [], []
            with self.timer.phase("augment"):
                for key in keys:
                    i = unique_misses[key][0]
                    im, lb = self.augmenter.augment_first_frame(
                        np.asarray(first_images[i]), np.asarray(first_labels[i]),
                        np.random.RandomState(0))
                    ims.append(im)
                    lbs.append(lb)
            with self.timer.phase("extract"):
                K = ims[0].shape[0]
                ft = self._extract_flat(torch.cat(ims))
                ft = ft.reshape((len(keys), K) + tuple(ft.shape[1:]))
            with self.timer.phase("disc_init"):
                solved, _ = disc_init(repeat_params(self.disc_params0, len(keys)), ft,
                                      torch.stack(lbs), self.disc_cfg)
                for k, key in enumerate(keys):
                    p = DiscParams(solved.project[k], solved.filter[k])
                    self.cache.save(specs[unique_misses[key][0]], L, p)
                    for i in unique_misses[key]:
                        params[i] = p
        return DiscParams(torch.stack([p.project for p in params]),
                          torch.stack([p.filter for p in params])), hits

    def _extract_flat(self, frames, chunk: int = 32):
        """Target-model-layer features of (M, 3, H, W) frames, in chunks."""
        L = self.disc_cfg.layer
        return torch.cat([self.backbone.extract_features(frames[s:s + chunk], output_layers=[L])[L]
                          for s in range(0, frames.shape[0], chunk)])

    def loss(self, disc_batch: DiscParams, images, labels, mask, bn_group=None, n_valid=None):
        """The forward over train frames 1 .. T-1 with gradients recorded.
        images (T, B, H, W, 3), labels (T, B, H, W, 1) (numpy or tensors),
        mask (B,) float sample validity. Writes each frame's new BN running
        statistics into the refiner as it goes (they chain across the
        frames, as in the JAX step). Returns (summed per-frame loss with its
        graph, accuracy).

        Data-parallel (parallel/train_step.py): the rows are this rank's,
        bn_group the process group over which the BatchNorm statistics are
        taken, and n_valid the global batch's number of valid samples (at
        least 1), which both results divide by; each rank's results are
        then its share of the global batch's."""
        dev = self.device
        images = torch.as_tensor(images).to(dev).permute(0, 1, 4, 2, 3)
        labels = torch.as_tensor(labels).to(dev).permute(0, 1, 4, 2, 3).float()
        mask = torch.as_tensor(mask, dtype=torch.float32).to(dev)
        T = images.shape[0]
        im_size = tuple(images.shape[-2:])
        if n_valid is None:
            n_valid = torch.clamp_min(mask.sum(), 1.0)
        layers = self.cfg.refnet_layers
        total = 0.0
        accs = []
        for t in range(1, T):
            with torch.no_grad():
                feats = self.backbone.extract_features(images[t], output_layers=self._all_layers)
                scores = classify_per_sample(disc_batch, feats[self.disc_cfg.layer])
            logits, bn_updates = seg_network_apply(self.refiner, scores,
                                                   {L: feats[L] for L in layers}, im_size,
                                                   layers=layers, train_bn=True,
                                                   bn_group=bn_group)
            apply_bn_updates(self.refiner, bn_updates)
            pred = torch.sigmoid(logits)
            y = labels[t]
            p = torch.clamp(pred, 1e-7, 1 - 1e-7)
            # per-sample pixel-mean BCE, masked mean over the batch
            bce = -(y * torch.log(p) + (1 - y) * torch.log(1 - p)).mean(dim=(1, 2, 3))
            total = total + (bce * mask).sum() / n_valid
            accs.append(iou_accuracy(pred[:, 0].detach(), y[:, 0]) * mask)
        acc = torch.stack(accs).sum() / (n_valid * (T - 1))
        return total, acc

    def train_step(self, disc_batch, images, labels, mask, optimizer: AMSGrad, lr: float,
                   group=None):
        """One optimizer step; returns {"stats/loss", "stats/accuracy"}.

        group: a torch.distributed process group whose ranks each hold rows
        of one global batch (data-parallel training, parallel/train_step.py).
        The BatchNorm statistics, the valid count, the gradients (one
        all-reduce of a flat buffer, before the step) and the returned stats
        are then the global batch's. None is this process alone."""
        optimizer.zero_grad()
        with self.timer.phase("forward"):
            mask = torch.as_tensor(mask, dtype=torch.float32).to(self.device)
            n_valid = torch.clamp_min(all_reduce_sum(mask.sum(), group), 1.0)
            total, acc = self.loss(disc_batch, images, labels, mask, bn_group=group,
                                   n_valid=n_valid)
        with self.timer.phase("backward"):
            total.backward()
            if group is not None:
                all_reduce_grads(optimizer.params, group)
        with self.timer.phase("step"):
            optimizer.step(lr)
        stats = all_reduce_sum(torch.stack([total.detach(), acc.detach()]), group)
        T = len(images)
        return {"stats/loss": float(stats[0]) / (T - 1), "stats/accuracy": float(stats[1])}


class Trainer:
    """Epoch loop with per-epoch dataset resampling, checkpoints with
    auto-resume, and console / JSONL / TensorBoard statistics.

    :param datasets: factories, each called once per epoch for fresh samples
    :param rng: the np.random.RandomState that orders each epoch's batches
        in a run of one process (the JAX trainer draws from the global
        generator); a run of several orders epoch e by RandomState(e), so
        that every process draws the same global batches
    :param prefetch: assemble the next batch on a background thread while
        the card runs the current step (utils/prefetch.py)
    :param mesh: a parallel.Mesh: train data-parallel over its processes
        (parallel/train_step.py), each feeding its rows of every batch;
        required where more than one process runs
    """

    def __init__(self, name, model: TrainerModel, datasets, checkpoints_path, log_path,
                 max_epochs=260, batch_size=16, lr=1e-3, lr_step=127, lr_gamma=0.1,
                 weight_decay=1e-5, load_latest=True, save_interval=1, mesh=None,
                 prefetch=True, rng=None):
        self.name = name
        self.model = model
        self.datasets = datasets
        self.checkpoints_path = Path(checkpoints_path) / name
        self.checkpoints_path.mkdir(exist_ok=True, parents=True)
        self.log_path = Path(log_path) / name
        self.log_path.mkdir(exist_ok=True, parents=True)
        self.epoch = 0
        self.max_epochs = max_epochs
        self.batch_size = batch_size
        self.base_lr = lr
        self.lr_step = lr_step
        self.lr_gamma = lr_gamma
        self.save_interval = save_interval
        self.prefetch = prefetch
        self.rng = rng if rng is not None else np.random.RandomState()
        self.stats = defaultdict(AverageMeter)
        self.mesh = mesh
        # several processes run this loop over the same global batches; each
        # materialises only its rows (parallel/distributed.py)
        self._n_proc = process_count() if mesh is None else mesh.size
        self._pid = process_index() if mesh is None else mesh.rank
        if self._n_proc > 1 and mesh is None:
            raise ValueError("multi-process training requires a global mesh "
                             "(Trainer(mesh=global_mesh()))")
        self._group = None if mesh is None else mesh.group
        if mesh is not None:
            replicated(mesh, model.refiner)
        self.optimizer = AMSGrad(model.refiner.parameters(), weight_decay)
        if load_latest:
            ckpts = sorted(self.checkpoints_path.glob(f"{name}_ep*.pth"))
            if ckpts:
                self.load_checkpoint(ckpts[-1])

    def _lr(self):
        """StepLR: base_lr * gamma ** ((epoch - 1) // step)."""
        return self.base_lr * (self.lr_gamma ** ((self.epoch - 1) // self.lr_step))

    # -- checkpointing ------------------------------------------------------

    def save_checkpoint(self):
        """Rank 0 writes (the refiner is replicated); train() calls it there."""
        torch.save({"name": self.name, "epoch": self.epoch,
                    "refiner": self.model.refiner.state_dict(),
                    "optimizer": self.optimizer.state_dict()},
                   self.checkpoints_path / ("%s_ep%04d.pth" % (self.name, self.epoch)))

    def load_checkpoint(self, file):
        print("Loading checkpoint", file)
        ckpt = torch.load(file, map_location=self.model.device, weights_only=True)
        self.epoch = int(ckpt["epoch"])
        self.model.refiner.load_state_dict(ckpt["refiner"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        if self.mesh is not None:
            replicated(self.mesh, self.model.refiner)
        print("Starting epoch", self.epoch + 1)

    # -- training loop ------------------------------------------------------

    def _batches(self, dataset):
        """Yields (images, labels, specs, mask) of this process's rows. The
        last partial batch is padded to batch_size by repeating its samples
        cyclically, with mask 0 on the repeats (the reference trains on the
        remainder). With several processes every one draws the epoch-seeded
        order, RandomState(epoch), and materialises only its contiguous rows
        (batch_rows) and its slice of the mask."""
        if self._n_proc > 1:
            order = np.random.RandomState(self.epoch).permutation(len(dataset))
            lo, hi = batch_rows(self.batch_size, self._pid, self._n_proc)
        else:
            order = self.rng.permutation(len(dataset))
            lo, hi = 0, self.batch_size
        for start in range(0, len(order), self.batch_size):
            idx = list(order[start:start + self.batch_size])
            n_real = len(idx)
            idx += [idx[i % n_real] for i in range(self.batch_size - n_real)]
            samples = [dataset[int(i)] for i in idx[lo:hi]]
            T = len(samples[0][0])
            images = np.stack([np.stack([s[0][t] for s in samples]) for t in range(T)])
            labels = np.stack([np.stack([s[1][t] for s in samples]) for t in range(T)])
            specs = SampleSpec.from_encoded([s[2] for s in samples])
            mask = np.zeros(self.batch_size, np.float32)
            mask[:n_real] = 1.0
            yield images, labels, specs, mask[lo:hi]

    def _prefetched(self, it):
        """One-ahead batch assembly on a background thread; only the worker
        touches the iterator, so every draw happens in the inline order."""
        return prefetch_iter(it, enabled=self.prefetch)

    def _tb_writer(self):
        """A TensorBoard writer where tensorboard imports, on rank 0 only;
        stats.jsonl is the primary log."""
        if self._pid != 0:
            return None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(str(self.log_path))

    def train(self):
        tb = self._tb_writer()
        # one writer per run: rank 0
        with (open(self.log_path / "stats.jsonl", "a") if self._pid == 0
              else contextlib.nullcontext()) as log_file:
            for epoch in range(self.epoch + 1, self.max_epochs + 1):
                self.epoch = epoch
                self.stats = defaultdict(AverageMeter)
                merged = _ConcatDataset([f() for f in self.datasets])
                runtime = AverageMeter()
                t0 = None
                n_batches = -(-len(merged) // self.batch_size)
                for i, (images, labels, specs, mask) in enumerate(
                        self._prefetched(self._batches(merged)), 1):
                    t0 = time.time() if t0 is None else t0
                    disc_batch, hits = self.model.build_disc_batch(images[0], labels[0], specs)
                    stats = self.model.train_step(disc_batch, images, labels, mask,
                                                  self.optimizer, self._lr(), self._group)
                    runtime.update(time.time() - t0)
                    t0 = time.time()
                    stats["stats/fcache_hits"] = hits
                    stats["stats/lr"] = self._lr()
                    for k, v in stats.items():
                        self.stats[k].update(v)
                    sps = self.batch_size / max(runtime.val, 1e-9)
                    print(f"{epoch}: {i}/{n_batches}, sps={sps:.2f} "
                          f"({self.batch_size / max(runtime.avg, 1e-9):.2f}), "
                          + ", ".join(f"{k.split('/')[-1]}={m.val:.5f} ({m.avg:.5f})"
                                      for k, m in self.stats.items()))
                if self._pid == 0:
                    if self.epoch % self.save_interval == 0:
                        self.save_checkpoint()
                    print(json.dumps({"epoch": self.epoch,
                                      **{k: m.avg for k, m in self.stats.items()}}),
                          file=log_file, flush=True)
                if self._n_proc > 1:
                    # every rank may load what rank 0 just wrote
                    barrier(f"{self.name} epoch {self.epoch} written")
                if tb is not None:
                    for k, m in self.stats.items():
                        tb.add_scalar(k, m.avg, self.epoch)
        if tb is not None:
            tb.close()
        print("%s done" % self.name)


class _ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i):
        k = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[k][i - int(self._offsets[k])]
