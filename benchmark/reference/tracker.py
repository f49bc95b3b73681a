"""The plain reference tracker: a frozen copy of the port's host-loop
tracker (frtm_tpu_torch/runtime/tracker.py) for objects that all start in
frame 0, in float32 with TF32 off, on the reference's own modules. Per
object a first-frame augment and a two-phase GN-CG init; then per frame:
extract, classify and decode each object, the soft merge, and each object's
online update (memory insert, a filter re-solve every `train_skipping`
frames).

`track_sequence` returns the label images, judges another tracker's labels
of the same frames, and keeps each object's memory at a frame asked for;
`follow_window` tracks a few frames from target models it is handed (the
window after another tracker's re-solve) and judges that tracker's labels
of them. A disagreement counts where this tracker's winner leads the
runner-up by a margin in probability (MARGIN, or each of MARGINS), so that
a tie decided otherwise by rounding does not."""
import numpy as np
import torch

from .augmenter import ImageAugmenter
from .discriminator import DiscParams, disc_apply, disc_init, disc_update, repeat_params

MARGIN = 0.5
MARGINS = (0.5, 0.2, 0.1, 0.05, 0.02)


def disable_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def soft_rows(masks: torch.Tensor) -> torch.Tensor:
    """The soft aggregation's softmax over [background, objects] odds,
    before mutual exclusion: masks (n_obj + 1, H, W), row 0 ignored."""
    p = masks.clamp(1e-7, 1 - 1e-7)
    p = torch.cat([(1.0 - p[1:]).amin(dim=0, keepdim=True), p[1:]])
    return torch.softmax(p / (1.0 - p), dim=0)


def merge_soft_masks(masks: torch.Tensor) -> torch.Tensor:
    """Soft aggregation + mutual exclusion (the port's merge_soft_masks)."""
    if masks.shape[0] == 2:
        p = masks[1].clamp(1e-7, 1 - 1e-7)
        r1 = p / (1.0 - p)
        r0 = (1.0 - p) / p
        win = (r1 > r0).to(masks.dtype)
        s1 = torch.sigmoid(r1 - r0)
        s0 = torch.sigmoid(r0 - r1)
        return torch.stack([s0 * (1.0 - win), s1 * win])
    segs = soft_rows(masks)
    onehot = torch.zeros_like(segs).scatter_(0, segs.argmax(dim=0, keepdim=True), 1.0)
    return segs * onehot


def masks_to_labels(masks: torch.Tensor, object_ids: torch.Tensor) -> torch.Tensor:
    if object_ids.shape[0] == 2:
        return torch.where(masks[1] > 0.5, object_ids[1], object_ids[0])
    idx = soft_rows(masks).argmax(dim=0)
    return object_ids[idx]


class Judge:
    """Sums, over judged frames, of the share of pixels that another
    tracker labels otherwise (`label_gap`), and for each margin m of MARGINS
    of the pixels whose winner leads the runner-up by m (the background's
    probability being the least of 1 - p over the objects; `share_m`) and
    of those that the other labels otherwise (`error_m`, their ratio)."""

    def __init__(self, device):
        self.sums = torch.zeros(1 + 2 * len(MARGINS), dtype=torch.float64, device=device)
        self.frames = 0

    def add(self, label, lead, other):
        diff = torch.from_numpy(np.ascontiguousarray(other)).to(label.device).to(label.dtype) != label
        parts = [diff.double().mean()]
        for m in MARGINS:
            sure = lead >= m
            parts += [(diff & sure).double().mean(), sure.double().mean()]
        self.sums += torch.stack(parts)
        self.frames += 1

    def read(self) -> dict:
        v = self.sums.cpu().tolist()
        out = dict(label_gap=v[0] / max(self.frames, 1))
        for i, m in enumerate(MARGINS):
            err, share = v[1 + 2 * i], v[2 + 2 * i]
            out[f"share_{m}"] = share / max(self.frames, 1)
            out[f"error_{m}"] = err / share if share > 0 else 0.0
        return out


class ReferenceTracker:

    def __init__(self, cfg, backbone, refiner, disc_params0: DiscParams, device,
                 tm_bf16: bool = False):
        """tm_bf16 (the control): the target model's features, scores,
        stored masks and weights rounded to bfloat16, the step below the
        float32 that the configuration states for it."""
        disable_tf32()
        self.q = (lambda t: t.bfloat16().float()) if tm_bf16 else (lambda t: t)
        self.cfg = cfg
        self.disc_cfg = cfg.disc
        self.device = torch.device(device)
        self.backbone = backbone.to(self.device).eval()
        self.refiner = refiner.to(self.device).eval()
        self.augmenter = ImageAugmenter(cfg.aug_params, self.device)
        self.disc_params0 = DiscParams(*(t.to(self.device).float() for t in disc_params0))
        self.layers = tuple(sorted(set(cfg.refnet_layers) | {cfg.disc.layer}, reverse=True))

    def _decode_frame(self, frame, params):
        """One frame (H, W, 3) uint8 numpy, each object's DiscParams ->
        ((n + 1, H, W) decoded masks, row 0 zero; each object's compressed
        features)."""
        dcfg, q = self.disc_cfg, self.q
        H, W = frame.shape[:2]
        im = torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        feats = self.backbone.extract_features(im.permute(2, 0, 1)[None],
                                               output_layers=self.layers)
        masks = torch.zeros((len(params) + 1, H, W), device=self.device)
        cfts = []
        for k, p in enumerate(params):
            scores, cft = disc_apply(p, q(feats[dcfg.layer]), clamp_output=dcfg.clamp_output)
            cfts.append(q(cft[0]))
            logits = self.refiner.apply(q(scores), {L: feats[L] for L in self.cfg.refnet_layers},
                                        (H, W), layers=self.cfg.refnet_layers)
            masks[k + 1] = torch.sigmoid(logits[0, 0])
        return masks, cfts

    @staticmethod
    def _merge(masks, ids):
        """(merged masks, labels, the winner's lead over the runner-up) of one
        frame's decoded masks."""
        pre = masks[1:].clamp(0, 1)
        top2 = torch.cat([(1.0 - pre).amin(dim=0, keepdim=True), pre]).topk(2, dim=0)[0]
        merged = merge_soft_masks(masks)
        return merged, masks_to_labels(merged, ids), top2[0] - top2[1]

    @torch.no_grad()
    def track_sequence(self, frames, first_labels, obj_ids, judged=None, until=None,
                       memory_at=None):
        """frames: (T, H, W, 3) uint8 numpy; first_labels: (H, W) uint8 label
        image of frame 0; obj_ids: the objects' labels; judged: {name: (T, H,
        W) uint8 labels} that another tracker gave; until: the last frame
        tracked (T - 1 where None); memory_at: the frame after whose update
        each object's memory is kept. Returns (labels (T, H, W) uint8,
        {name: Judge.read() over the tracked frames, and `first_clear_error`
        over those before the first filter re-solve, at MARGIN}, [each
        object's memory (samples, labels, weights, the init's slots) at
        `memory_at`] or None)."""
        dev, dcfg, q = self.device, self.disc_cfg, self.q
        judged = judged or {}
        T, H, W = frames.shape[:3]
        until = T - 1 if until is None else min(int(until), T - 1)
        targets = []
        for obj_id in obj_ids:
            mask = (first_labels == obj_id).astype(np.float32)
            rng = np.random.RandomState(0)  # per-object reseed, as the reference
            im_aug, lb_aug = self.augmenter.augment_first_frame(frames[0], mask[..., None], rng)
            ft = self.backbone.extract_features(im_aug, output_layers=[dcfg.layer])
            params, state = disc_init(repeat_params(self.disc_params0, 1),
                                      q(ft[dcfg.layer])[None], lb_aug[None], dcfg)
            targets.append([DiscParams(*map(q, params)), state])
        init_slots = lb_aug.shape[0]
        ids = torch.tensor([0] + list(obj_ids), dtype=torch.int32, device=dev)
        labels = np.zeros((T, H, W), np.uint8)
        labels[0] = first_labels
        first = max(int(dcfg.train_skipping), 1)     # frames before the first re-solve
        whole = {name: Judge(dev) for name in judged}
        head = {name: Judge(dev) for name in judged}
        memory = None
        for t in range(1, until + 1):
            masks, cfts = self._decode_frame(frames[t], [tgt[0] for tgt in targets])
            merged, label, lead = self._merge(masks, ids)
            labels[t] = label.cpu().numpy()
            for name, other in judged.items():
                whole[name].add(label, lead, other[t])
                if t <= first:
                    head[name].add(label, lead, other[t])
            for k, tgt in enumerate(targets):
                params, tgt[1] = disc_update(tgt[0], tgt[1], cfts[k],
                                             q(merged[k + 1])[None, None], dcfg)
                tgt[0] = DiscParams(*map(q, params))
            if t == memory_at:
                memory = [(m.samples[0].clone(), m.labels[0].clone(), m.weights[0].clone(),
                           init_slots) for m in (tgt[1].memory for tgt in targets)]
        gaps = {name: dict(whole[name].read(),
                           first_clear_error=head[name].read()[f"error_{MARGIN}"])
                for name in judged}
        return labels, gaps, memory

    @torch.no_grad()
    def follow_window(self, frames, project, filters, obj_ids, judged=None):
        """Track frames (w, H, W, 3) uint8 numpy with the target models it is
        handed, (N, c, Cin, 1, 1) projections and (N, 1, c, 3, 3) filters, one
        lane an object, without updating them. Returns (labels (w, H, W)
        uint8, {name: Judge.read()} of judged: {name: (w, H, W) uint8 labels
        of the same frames}, [each object's memory inserts, the compressed
        features (m, c, h, w) and stored masks (m, 1, H, W) of the frames
        whose mask holds 10 foreground pixels, as disc_update inserts])."""
        q = self.q
        judged = judged or {}
        params = [DiscParams(q(project[k:k + 1].float()), q(filters[k:k + 1].float()))
                  for k in range(len(obj_ids))]
        ids = torch.tensor([0] + list(obj_ids), dtype=torch.int32, device=self.device)
        labels = np.zeros(frames.shape[:3], np.uint8)
        judges = {name: Judge(self.device) for name in judged}
        inserts = [([], []) for _ in obj_ids]
        for t in range(frames.shape[0]):
            masks, cfts = self._decode_frame(frames[t], params)
            merged, label, lead = self._merge(masks, ids)
            labels[t] = label.cpu().numpy()
            for name, other in judged.items():
                judges[name].add(label, lead, other[t])
            for k, (feats, stored) in enumerate(inserts):
                y = q(merged[k + 1])
                if int((y > 0.5).sum()) >= 10:
                    feats.append(cfts[k][0])
                    stored.append(y[None])
        inserts = [(torch.stack(f) if f else None, torch.stack(m) if m else None)
                   for f, m in inserts]
        return labels, {name: j.read() for name, j in judges.items()}, inserts
