"""The fused sequence tracker (frtm_tpu/runtime/sequence_tracker.py).

The backbone is frozen and stateless, so the pyramid of the WHOLE sequence is
extracted in batches before tracking starts, and each object's projection
(fixed after init) compresses all frames in one convolution. Between two
filter re-solves the target models are constant, so classify -> decode ->
merge for a whole `train_skipping` window runs as one batch of
window x objects; only the memory inserts inside a window are sequential.
Objects are lanes with start-frame masks: all are initialised up front, in
one backbone pass over every object's augmented frames and one solve of
all target models (models/discriminator.py takes the object axis, as the
JAX package's `jax.vmap` does); a lane is silent before its start frame,
contributes its ground truth at it, and is tracked after it. In the loop,
each tracked frame makes one memory insert of all lanes and each window at
most one re-solve of all lanes, whose result a lane takes where it is due.

Two merge modes:
  * 'online'  — per-frame soft aggregation with entering objects' ground
    truth rows taking part; labels per frame.
  * 'deferred' — per-frame updates use the exclusive merge, but the outputs
    are the raw suppressed per-object soft masks, merged once over the whole
    sequence with ground truth inserted at the start frames.

What the JAX package compiles as two `lax.scan` programs is here one Python
loop over windows (`_track`; `_window_track` runs it at a window of
train_skipping frames): the per-frame program is that loop at a window of 1
(`_scan_track`), taken when some object's start frame does not
fall on a window boundary. The order of work is the JAX package's: the
whole-sequence extract is enqueued BEFORE the host augment and nothing in
it waits for the card, so the card computes the pyramid while the host
inpaints; frames are uploaded, and the uploads have landed, before the fps
clock starts; downloads happen after it. The loop reads nothing back from
the card: the >= 10 pixel gate of the memory insert and the choice between
the old and the re-solved filter are tensors (models/discriminator.py).

Nothing is compiled per shape, so there is no `scan_bucket`: the JAX package
pads the tracked frames to a multiple of it (and skips the pad windows) so
that sequence lengths share a program; the port tracks the real number of
frames and its last window is short. Multilayer target models
(cfg.disc_layers) ride the same loop: per layer a projection of every frame,
a grouped classification and the memory inserts, the per-layer score maps
concatenated for the decoder, and one re-solve decision per object (its
first layer's counter) for all its layers. Not ported yet: `mesh` and the
sharded paths.

Two augment backends, as in the JAX class: "host" (models/augmenter.py, one
spec after another, its batches made before the init or, in the pipelined
run_dataset, while the previous sequence tracks) and "device"
(models/device_augmenter.py, every spec of a round in one batch; each
object is augmented inside the timed region from its start frame's copy on
the card, and the dense init takes the batches as they are).

With cfg.compute_dtype = "bfloat16", as in the JAX class: the whole-sequence
pyramid is extracted in bfloat16 and kept in it (half the memory), the
decoder runs on a bfloat16 copy of the refiner with features and scores cast
at its door (kernels 1 and 2 take their bfloat16 instances) and the sigmoid
is taken in float32 on the cast logits; the init's extract over the augmented
frames computes in bfloat16 and emits float32; the projection upcasts the
target model's layer to float32; target model, solver, memory and merge stay
float32.
"""
import contextlib
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import TrackerConfig, compute_dtype_of
from ..data.image import imwrite_indexed
from ..device import resolve_device
from ..models.aug_compose import compose_aug_batch, pack_bits, pack_compact_batch, unpack_bits
from ..models.augmenter import ImageAugmenter
from ..models.device_augmenter import DeviceAugmenter
from ..models.discriminator import (DiscParams, DiscState, classify_objects, disc_init,
                                    init_disc_params, insert_sample, project_all,
                                    repeat_params, resolve_due)
from ..models.multilayer import layer_configs, ml_disc_init, starting_params
from ..models.resnet import ResNet
from ..models.seg_network import SegNetwork, seg_network_apply, seg_network_reduce
from ..ops.conv import compute_copy
from ..utils.meters import AverageMeter
from ..utils.prefetch import prefetch_iter
from ..utils.profiling import PhaseTimer, count_host_syncs


def merge_volume(fg: torch.Tensor, obj_ids_lut: torch.Tensor) -> torch.Tensor:
    """Whole-volume soft aggregation: fg (T, N, H, W) -> (T, H, W) uint8 labels."""
    fg = fg.clamp(1e-7, 1 - 1e-7)
    bg = (1.0 - fg).amin(dim=1, keepdim=True)
    p = torch.cat([bg, fg], dim=1)
    idx = torch.softmax(p / (1.0 - p), dim=1).argmax(dim=1)
    return obj_ids_lut[idx].to(torch.uint8)


def merge_rows_and_label(rows: torch.Tensor, obj_ids_lut: torch.Tensor):
    """Soft aggregation and labelling in one pass: rows (..., N, H, W) of
    suppressed soft foreground masks -> (merged (..., N, H, W) exclusive
    object rows, uint8 (..., H, W) label image).

    The winners are those of merge_soft_masks followed by masks_to_labels,
    with one softmax: the second step's argmax over the exclusive volume
    reduces to "the step-1 winner keeps its label iff its merged
    probability > 0.5, else background" (for a winner value s the re-derived
    odds are s / (1 - s) against (1 - s) / s, and the first is larger iff
    s > 0.5; ties go to background, the first maximum)."""
    N = rows.shape[-3]
    lut = obj_ids_lut
    if N == 1:
        # single object: the 2-way softmax over [bg, fg] odds is exactly the
        # sigmoid of the odds difference
        p = rows[..., 0, :, :].clamp(1e-7, 1 - 1e-7)
        r1 = p / (1.0 - p)
        r0 = (1.0 - p) / p
        win = r1 > r0
        s1 = torch.sigmoid(r1 - r0)
        merged = (s1 * win.to(s1.dtype)).unsqueeze(-3)
        label = torch.where(win & (s1 > 0.5), lut[1], lut[0])
        return merged, label.to(torch.uint8)
    p = rows.clamp(1e-7, 1 - 1e-7)
    bg = (1.0 - p).amin(dim=-3)
    r = p / (1.0 - p)
    r_bg = bg / (1.0 - bg)
    m = torch.maximum(r.amax(dim=-3), r_bg)
    e = torch.exp(r - m.unsqueeze(-3))
    e_bg = torch.exp(r_bg - m)
    z = e_bg + e.sum(dim=-3)
    seg = e / z.unsqueeze(-3)             # object softmax rows
    seg_bg = e_bg / z
    k = e.argmax(dim=-3)                  # winner among objects (first max)
    s_win = seg.amax(dim=-3)
    obj_wins = s_win > seg_bg             # strict: ties go to background
    lane = torch.arange(N, device=rows.device).view(N, 1, 1)
    merged = seg * ((lane == k.unsqueeze(-3)) & obj_wins.unsqueeze(-3)).to(seg.dtype)
    label = torch.where(obj_wins & (s_win > 0.5), lut[1:][k], lut[0])
    return merged, label.to(torch.uint8)


# the target models of all objects, with the object axis: (DiscParams,
# DiscState), or with multilayer models ({layer: DiscParams}, {layer: DiscState})
Models = Tuple[DiscParams, DiscState]

# frames per backbone pass of the init's extract over all objects' augmented
# frames (four objects of the eval config's 6 frames go in one pass)
INIT_EXTRACT_CHUNK = 32


class BatchedSequenceTracker:
    """Whole-sequence tracking as (batched extract) + (one loop over windows).

    Beyond the JAX class: `device` (the card unless "cpu" is asked for),
    `disc_params0` and `augmenter` as for the host-loop Tracker, and
    `profile`: the timed pass then synchronises the card at every phase edge
    (nothing overlaps, fps drops) and counts the scan's host waits, so that
    `last_phase_stats` holds device-inclusive phase seconds."""

    def __init__(self, cfg: TrackerConfig, backbone: ResNet, refiner: SegNetwork,
                 extract_chunk: int = 8, merge_mode: str = "online",
                 augment_backend: str = "host", decode_chunk: int = 0,
                 aug_compact: bool = False, device=None,
                 disc_params0: Optional[DiscParams] = None, augmenter=None,
                 profile: bool = False):
        """decode_chunk: decode a window in sub-batches of this many lanes
        (0 = the whole window at once). aug_compact: take first-frame
        augment batches in the compact encoding and compose them before the
        init (models/aug_compose.py). Both default to off, as the JAX class
        has them off the TPU; the device augment backend takes no compact
        batches."""
        if merge_mode not in ("online", "deferred"):
            raise ValueError(f"merge_mode {merge_mode!r}: 'online' or 'deferred'")
        self.dtype = compute_dtype_of(cfg)
        if augment_backend not in ("host", "device"):
            raise ValueError(f"augment_backend {augment_backend!r}: 'host' or 'device'")
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.disc_cfg = cfg.disc
        self.backbone = backbone.to(dev).eval()
        self.refiner = refiner.to(dev).eval()
        # the copies that compute (the modules themselves in float32), made once
        self.backbone_c = compute_copy(self.backbone, self.dtype)
        self.refiner_c = compute_copy(self.refiner, self.dtype)
        self.augment_backend = augment_backend
        self.augmenter = augmenter or (DeviceAugmenter(cfg.aug_params, dev)
                                       if augment_backend == "device"
                                       else ImageAugmenter(cfg.aug_params, dev))
        self.multilayer = bool(cfg.disc_layers)
        self.disc_cfgs = layer_configs(cfg)         # {layer: DiscConfig}, sorted
        self.disc_params0 = starting_params(cfg, self.disc_cfgs, disc_params0, dev,
                                            init_disc_params)
        # the pipelined run_dataset prepares the next sequence on this stream
        self._prep_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.extract_chunk = extract_chunk
        self.merge_mode = merge_mode
        self.decode_chunk = decode_chunk
        self.aug_compact = aug_compact and augment_backend != "device"
        self.profile = profile
        self._all_layers = tuple(sorted(set(cfg.refnet_layers) | set(self.disc_cfgs),
                                        reverse=True))
        self.last_phase_report = ""
        self.last_phase_stats = {}
        self.last_models: Optional[Models] = None
        self.last_feats_dtype = None    # the type the last run kept its pyramid in

    # -- frames and features --------------------------------------------------

    def _upload_chunks(self, images_np) -> List[torch.Tensor]:
        """The frames as (<= extract_chunk, H, W, 3) uint8 tensors on the
        device. Called before the timed region, as the reference preloads
        all frames before its fps clock starts."""
        C = self.extract_chunk
        return [torch.from_numpy(images_np[s:s + C]).to(self.device)
                for s in range(0, images_np.shape[0], C)]

    def _extract_sequence(self, chunks) -> dict:
        """Chunked batched feature extraction over all frames:
        {layer: (T, c, h, w)} in the compute type, in which the pyramid
        stays. Only enqueues; nothing waits for the card."""
        outs = [self.backbone_c.extract_features(c.permute(0, 3, 1, 2),
                                                 output_layers=self._all_layers,
                                                 out_dtype=self.dtype)
                for c in chunks]
        return {L: torch.cat([o[L] for o in outs]) for L in outs[0]}

    def _frame_dev(self, t: int, chunks) -> torch.Tensor:
        """Frame t, (H, W, 3) uint8, from the preloaded buffers."""
        if t == 0:
            return self._frame0_dev
        C = self.extract_chunk
        return chunks[(t - 1) // C][(t - 1) % C]

    def _frame0_label(self, objects, im_size) -> np.ndarray:
        lb = np.zeros(im_size, np.uint8)
        for obj_id, start_idx, mask, _ in objects:
            if start_idx == 0:
                lb[mask > 0] = obj_id
        return lb

    # -- objects: augment and init ----------------------------------------------

    def _collect_objects(self, sequence):
        """[(obj_id, start frame index, start mask (H, W) float32, init
        image)] from the sequence's start-frame metadata, by (start, id)."""
        frame_of = {f: i for i, f in enumerate(sequence.frame_names)}
        objects = []
        for frame_name, obj_ids in sequence.start_frames.items():
            idx = frame_of[frame_name]
            image, labels, _ = sequence[idx]
            for obj_id in obj_ids:
                mask = (np.asarray(labels).squeeze() == obj_id).astype(np.float32)
                objects.append((obj_id, idx, mask, image))
        objects.sort(key=lambda o: (o[1], o[0]))
        return objects

    def _pack_aug_batch(self, im_aug, lb_aug):
        """One object's dense augment batch as the init takes it: slot 0 of
        the images elided (it IS the real frame, which the preload holds)
        and the binary masks bit-packed (np.packbits layout). Returns
        (ims_rest (K-1, 3, H, W) uint8, lbs_packed (K, H, ceil(W / 8)) uint8)
        on the device.

        On device="cpu" `.to(device)` returns its argument, so `ims_rest`
        shares memory with `im_aug`. That is safe because the port's
        ImageAugmenter allocates a fresh batch in every call and reuses no
        buffer (a test holds it); an augmenter that did would have to hand
        out copies, since the pipelined run_dataset prepares the next
        sequence while this one's batches are still in use."""
        ims = torch.as_tensor(im_aug).to(self.device)
        lbs = torch.as_tensor(lb_aug).to(self.device)
        return ims[1:], pack_bits(lbs[:, 0])

    def _augment_objects(self, objects, timer: Optional[PhaseTimer] = None):
        """First-frame augmentation for every object, in object order.
        Returns per object (ims_rest, lbs_packed) as from _pack_aug_batch,
        or in compact mode a pack_compact_batch dict."""
        timer = timer or PhaseTimer(sync=False)
        batches = []
        for obj_id, start_idx, mask, image in objects:
            rng = np.random.RandomState(0)  # per-object reseed, as the reference
            if self.aug_compact:
                with timer.phase("augment"):
                    compact = self.augmenter.augment_first_frame(
                        image, mask[..., None], rng, compact=True)
                with timer.phase("aug_upload"):
                    batches.append(pack_compact_batch(compact))
                continue
            with timer.phase("augment"):
                im_aug, lb_aug = self.augmenter.augment_first_frame(image, mask[..., None], rng)
            with timer.phase("aug_upload"):
                batches.append(self._pack_aug_batch(im_aug, lb_aug))
        return batches

    def _init_objects_dense(self, images, labels) -> Models:
        """The target models of all objects: one backbone pass over every
        object's augmented frames (in chunks of INIT_EXTRACT_CHUNK frames)
        and one two-phase GN-CG init of all of them.

        :param images: (N, K, 3, H, W) uint8
        :param labels: (N, K, 1, H, W)
        """
        N, K = images.shape[:2]
        flat = images.flatten(0, 1)
        outs = [self.backbone_c.extract_features(flat[i:i + INIT_EXTRACT_CHUNK],
                                                 output_layers=list(self.disc_cfgs))
                for i in range(0, N * K, INIT_EXTRACT_CHUNK)]
        # emits float32
        ft = {L: (outs[0][L] if len(outs) == 1 else torch.cat([o[L] for o in outs]))
              .unflatten(0, (N, K)) for L in self.disc_cfgs}
        if self.multilayer:
            return ml_disc_init({L: repeat_params(p, N) for L, p in self.disc_params0.items()},
                                ft, labels, self.disc_cfgs)
        return disc_init(repeat_params(self.disc_params0, N), ft[self.disc_cfg.layer], labels,
                         self.disc_cfg)

    def _init_objects(self, f0, ims_rest, lbs_packed):
        """Init from the packed dense batches: reattach slot 0, unpack the
        masks. Returns (models, (N, H, W) float32 slot-0 masks, the scan's
        start masks)."""
        W = f0[0].shape[1]
        images = torch.cat([torch.stack(f0).permute(0, 3, 1, 2)[:, None],
                            torch.stack(ims_rest)], dim=1)
        labels = unpack_bits(torch.stack(lbs_packed), W)[:, :, None]
        return self._init_objects_dense(images, labels), labels[:, 0, 0].float()

    def _init_objects_compact(self, f0, packs):
        """Init from compact encodings: each object's batch is composed on
        the device from its packed pieces. Returns as _init_objects."""
        pairs = [compose_aug_batch(f.permute(2, 0, 1), pk) for f, pk in zip(f0, packs)]
        images = torch.stack([im for im, _ in pairs])
        labels = torch.stack([lb for _, lb in pairs])
        return self._init_objects_dense(images, labels), labels[:, 0, 0].float()

    # -- the frame loop ---------------------------------------------------------

    def _decode(self, scores, reduced, im_size):
        """(B, 1, h, w) scores (in the compute type; a list of them, one per
        layer, with multilayer models) and per-lane TSE reductions -> (B, H, W)
        float32 soft foreground masks, in sub-batches of decode_chunk where
        that divides B."""
        layers = self.cfg.refnet_layers
        multi = isinstance(scores, list)
        B, dc = (scores[0] if multi else scores).shape[0], self.decode_chunk
        if dc and B > dc and B % dc == 0:
            logits = torch.cat([
                seg_network_apply(self.refiner_c,
                                  [sc[i:i + dc] for sc in scores] if multi else scores[i:i + dc],
                                  None, im_size, layers=layers,
                                  reduced={L: (h[i:i + dc], hp[i:i + dc])
                                           for L, (h, hp) in reduced.items()})
                for i in range(0, B, dc)])
        else:
            logits = seg_network_apply(self.refiner_c, scores, None, im_size, layers=layers,
                                       reduced=reduced)
        return torch.sigmoid(logits[:, 0].float())

    def _track(self, feats_all, models: Models, start_frames, start_masks,
               obj_ids_lut, im_size, window: int):
        """Track frames 1..T' in windows of `window` frames: one batched
        classify + decode of window x objects lanes, a merge per frame, per
        tracked frame one memory insert of all lanes, then, when the host's
        facts (which lanes are tracked, their frame counters) say that some
        lane is due, one filter re-solve of all lanes, whose result each
        lane takes where it is due on the device: tracked, on its own
        cadence and with >= 10 foreground pixels, as the JAX `due`.

        :param feats_all:    {layer: (T', c, h, w)} frames 1..T'
        :param models:       the target models of all objects (Models); the
                             states are updated in place
        :param start_frames: per object, its start frame index (host ints)
        :param start_masks:  (N, H, W) float32 ground-truth start masks
        :param obj_ids_lut:  (N + 1,) int labels, background first
        :return: ((T', H, W) uint8 labels (online) or (T', N, H, W) float32
                 suppressed soft rows (deferred), the updated models)
        """
        cfg = self.disc_cfg
        cfgs = self.disc_cfgs
        online = self.merge_mode == "online"
        N = len(start_frames)
        W = window
        dev = self.device
        layers = self.cfg.refnet_layers
        params, states = models if self.multilayer else ({cfg.layer: models[0]},
                                                         {cfg.layer: models[1]})
        # every layer follows the first layer's counter, as in the JAX scan
        counter = states[next(iter(cfgs))]
        n_track = feats_all[next(iter(cfgs))].shape[0]
        compressed_all = {L: project_all(feats_all[L].float(), params[L].project) for L in cfgs}
        t_all = torch.arange(1, n_track + 1, device=dev)[:, None]
        starts = torch.stack([torch.full((), s, device=dev) for s in start_frames])
        active_all = t_all > starts          # (T', N) tracked this frame
        fresh_all = t_all == starts          # entering this frame
        # a lane's frame counter after frame t is t - (start - counter at init)
        base = torch.stack([torch.full((), s - f, device=dev)
                            for s, f in zip(start_frames, counter.frame_num)])
        cadence_all = active_all & ((t_all - base) % cfg.train_skipping == 0)
        outs = []
        for i0 in range(0, n_track, W):
            i1 = min(i0 + W, n_track)
            w = i1 - i0
            active = active_all[i0:i1]
            fresh = fresh_all[i0:i1]
            # the same facts on the host, where the control flow needs them
            active_h = [[t > s for s in start_frames] for t in range(i0 + 1, i1 + 1)]
            entering = any(s in range(i0 + 1, i1 + 1) for s in start_frames)

            cft = {L: c[i0:i1] for L, c in compressed_all.items()}     # (w, N, c, h, w)
            scores = []
            for L, c in cft.items():
                s = classify_objects(c, params[L].filter, clamp_output=cfgs[L].clamp_output)
                scores.append(s.reshape(w * N, 1, *s.shape[-2:]).to(self.dtype))
            # the object-independent TSE reductions run once per frame and
            # are repeated, at 32 channels, across the object lanes
            red = seg_network_reduce(self.refiner_c, {L: feats_all[L][i0:i1] for L in layers},
                                     layers)
            if N > 1:
                red = {L: (h.repeat_interleave(N, dim=0), hp.repeat_interleave(N, dim=0))
                       for L, (h, hp) in red.items()}
            y = self._decode(scores if self.multilayer else scores[0], red, im_size)
            y = y.view(w, N, *y.shape[-2:]) * active[..., None, None]
            if entering:
                # suppress tracked masks under this window's entering objects
                sup = torch.prod(1.0 - start_masks[None] * fresh[..., None, None], dim=1)
                y = y * sup[:, None]
                rows = torch.where(fresh[..., None, None], start_masks[None], y) if online else y
            else:
                rows = y
            merged, labels = merge_rows_and_label(rows, obj_ids_lut)
            outs.append(labels if online else rows)

            if not cfg.update_filters:
                for state in states.values():
                    state.frame_num = [f + sum(a[k] for a in active_h)
                                       for k, f in enumerate(state.frame_num)]
                continue
            enough = ((merged > 0.5).sum(dim=(-2, -1)) >= 10) & active      # (w, N)
            for f in range(w):
                if any(active_h[f]):
                    for L, state in states.items():
                        insert_sample(state, cft[L][f], merged[f][:, None], enough[f],
                                      active_h[f], cfgs[L])
            if any(a and n % cfg.train_skipping == 0
                   for a, n in zip(active_h[-1], counter.frame_num)):
                due = cadence_all[i1 - 1] & enough[-1]
                for L, state in states.items():
                    params[L] = resolve_due(params[L], state, due, cfgs[L])
        models = (params, states) if self.multilayer else (params[cfg.layer], states[cfg.layer])
        return torch.cat(outs), models

    def _window_track(self, *args):
        """The windowed loop, a window of train_skipping frames: with every
        start frame on a window boundary the re-solves fall exactly at the
        window ends, as in the per-frame loop."""
        return self._track(*args, window=max(int(self.disc_cfg.train_skipping), 1))

    def _scan_track(self, *args):
        """The per-frame loop: every object on its own re-solve cadence."""
        return self._track(*args, window=1)

    def _merge_volume_windows(self, outs, start_frames, start_masks, lut, T,
                              window: int = 32):
        """Deferred whole-sequence merge in windows of `window` frames, so
        that its temporaries are bounded whatever the sequence length: frame
        0 is an all-zeros row, frame t > 0 is outs[t - 1], and each object's
        start mask is inserted at its start frame. Equal to the one-shot
        merge (the merge is per frame)."""
        chunks = []
        for w0 in range(0, T, window):
            w1 = min(w0 + window, T)
            fg = outs[max(w0 - 1, 0):w1 - 1]
            if w0 == 0:
                fg = torch.cat([torch.zeros_like(outs[:1]), fg])
            else:
                fg = fg.clone()
            for k, start_idx in enumerate(start_frames):
                if w0 <= start_idx < w1:
                    fg[start_idx - w0, k] = start_masks[k]
            chunks.append(merge_volume(fg, lut))
        return torch.cat(chunks)

    # -- entry points -----------------------------------------------------------

    def prepare_sequence(self, sequence, stream=None) -> dict:
        """The host-side preparation of a sequence, separable from tracking:
        stack the frames, upload them, and run the first-frame augmentation
        (the host backend's; the device backend augments inside the timed
        region). The result feeds run_sequence(preloaded=).

        stream: a CUDA stream to do the device's share on (uploads, the
        augmenter's warps, the bit-packing) when another thread calls this
        while the tracker's own stream is busy with the previous sequence.
        The result then carries an event, recorded when that work was
        enqueued, which run_sequence makes its stream wait for."""
        images_np = np.stack([sequence[t][0] for t in range(len(sequence))])
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            prep = {"images_np": images_np,
                    "frame0_dev": torch.from_numpy(images_np[0]).to(self.device),
                    "chunks": self._upload_chunks(images_np[1:]),
                    "aug_batches": (None if self.augment_backend == "device" else
                                    self._augment_objects(self._collect_objects(sequence))),
                    "ready": None}
            if stream is not None:
                prep["ready"] = torch.cuda.Event()
                prep["ready"].record(stream)
        return prep

    def _adopt(self, prep):
        """Make the tracker's stream the user of what `prep` holds on the
        device: wait for the event of the stream that made it, and tell the
        allocator that these tensors are now read on this stream (it would
        otherwise hand their memory back to the other stream as soon as they
        are freed, while work queued here may still read it)."""
        if prep["ready"] is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_event(prep["ready"])
        stack = [prep["frame0_dev"], prep["chunks"], prep["aug_batches"]]
        while stack:
            item = stack.pop()
            if isinstance(item, torch.Tensor):
                item.record_stream(current)
            elif isinstance(item, dict):
                stack.extend(item.values())
            elif isinstance(item, (list, tuple)):
                stack.extend(item)

    def run_sequence(self, sequence, speedrun: bool = False, soft: bool = False,
                     aug_batches=None, preloaded=None):
        """Track a sequence (objects may enter mid-sequence). Returns (list
        of (H, W) uint8 label images, fps).

        aug_batches: precomputed first-frame augment batches (from
        _augment_objects, same object order; the host backend's only, the
        device backend always augments in the timed region); the timed
        region then excludes augmentation. preloaded: a prepare_sequence() result. speedrun: one
        untimed pass first (the convolution algorithm search, first
        launches). soft=True (merge_mode='deferred' only) returns the raw
        soft foreground volume (T, N, H, W) float32, ground truth inserted
        at the start frames, instead of labels."""
        if soft and self.merge_mode != "deferred":
            raise ValueError("soft output is the deferred merge's pre-merge volume")
        if preloaded is not None:
            images_np = preloaded["images_np"]
            self._adopt(preloaded)
            self._frame0_dev = preloaded["frame0_dev"]
            chunks = preloaded["chunks"]
            if aug_batches is None:
                aug_batches = preloaded["aug_batches"]
        else:
            images_np = np.stack([sequence[t][0] for t in range(len(sequence))])
            self._frame0_dev = torch.from_numpy(images_np[0]).to(self.device)
            chunks = self._upload_chunks(images_np[1:])

        if speedrun:
            self._run(images_np, sequence, PhaseTimer(sync=False), chunks, soft=soft,
                      aug_batches=aug_batches)
        timer = PhaseTimer(sync=self.profile, device=self.device)
        # the preload has landed (and a warm-up pass has drained) before the clock
        self._synchronize()
        t0 = time.perf_counter()
        result = self._run(images_np, sequence, timer, chunks, soft=soft,
                           aug_batches=aug_batches)
        self._synchronize()
        fps = len(sequence) / max(time.perf_counter() - t0, 1e-9)
        self.last_phase_report = timer.report()
        stats = timer.stats()
        if "scan" in stats:
            stats["scan"]["host_syncs"] = self._scan_host_syncs.count
            stats["scan"]["host_syncs_at"] = list(self._scan_host_syncs.where)
        self.last_phase_stats = stats
        # downloads happen after the clock
        if soft:
            return result[0].cpu().numpy(), fps
        outputs = []
        for arr in result:
            a = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr, np.uint8)
            outputs.extend(list(a) if a.ndim == 3 else [a])
        return outputs, fps

    def run_dataset(self, dataset, out_path, speedrun=False, restart=None, pipeline=False):
        """Track every sequence, write indexed PNGs under
        out_path/<sequence>/, report the average fps: the surface of the
        host-loop Tracker.run_dataset. The next sequence's frames are decoded
        (`preload()`) on a background thread while the current one tracks;
        sequences that are done release their decoded frames.

        pipeline=True moves the whole host-side preparation of the next
        sequence (frame stacking, uploads, first-frame augmentation:
        prepare_sequence) onto that thread, and on the card onto a stream of
        its own, which the tracker's stream joins through an event before it
        reads what was prepared. The outputs are the same (the augmenter's
        random draws are reseeded per object). Per-sequence fps then
        excludes augmentation (printed as 'ex-augment') and is not comparable
        to the default protocol's; the aggregate line gives frames over the
        whole wall, PNG writes included. How much wall it saves depends on
        the host: the preparation is mostly Python (the Telea inpaint) and
        shares the interpreter lock with the thread that issues the
        tracker's launches, so the two overlap only in part.
        """
        out_path = Path(out_path)
        out_path.mkdir(exist_ok=True, parents=True)
        fps_meter = AverageMeter()
        print("Evaluating", dataset.name)
        restarted = restart is None
        sequences = []
        for sequence in dataset:
            if not restarted:
                if sequence.name != restart:
                    continue
                restarted = True
            sequences.append(sequence)

        def prefetch(seq):
            if hasattr(seq, "preload"):
                seq.preload()
            if not pipeline:
                return seq, None
            return seq, self.prepare_sequence(seq, stream=self._prep_stream)

        t_all = time.perf_counter()
        n_frames = 0
        for i, (sequence, prep) in enumerate(prefetch_iter(map(prefetch, sequences))):
            outputs, seq_fps = self.run_sequence(sequence, speedrun, preloaded=prep)
            fps_meter.update(seq_fps)
            n_frames += len(sequence)
            tag = " (ex-augment)" if pipeline and self.augment_backend != "device" else ""
            print(f"{sequence.name}: {seq_fps:.2f} fps{tag}")
            dst = out_path / sequence.name
            dst.mkdir(exist_ok=True)
            for lb, f in zip(outputs, sequence.frame_names):
                imwrite_indexed(dst / (f + ".png"), lb)
            sequence.preloaded = None   # release decoded frames
            sequences[i] = None
        wall = time.perf_counter() - t_all
        print("Average frame rate: %.2f fps" % fps_meter.avg)
        if pipeline:
            extra = ", incl. speedrun warm-up passes" if speedrun else ""
            print("Pipelined dataset pass: %.2f fps aggregate "
                  "(%d frames / %.1fs wall, incl. PNG writes%s)"
                  % (n_frames / max(wall, 1e-9), n_frames, wall, extra))
        return fps_meter.avg

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _run(self, images_np, sequence, timer: PhaseTimer, chunks, soft: bool = False,
             aug_batches=None):
        T = images_np.shape[0]
        im_size = tuple(images_np.shape[1:3])
        objects = self._collect_objects(sequence)
        if not objects:
            raise ValueError("sequence has no objects")
        frame0_label = self._frame0_label(objects, im_size)
        if T == 1:  # nothing to track: the output is the start labels
            return (frame0_label,)
        start_frames = [o[1] for o in objects]
        # uploaded while the card's queue is still empty
        lut = torch.tensor([0] + [o[0] for o in objects], dtype=torch.int32, device=self.device)

        # The extract reads only frames that are already on the card, so it
        # is enqueued before the augment and runs under the host's part of it.
        with timer.phase("extract"):
            feats_all = self._extract_sequence(chunks)
        self.last_feats_dtype = feats_all[next(iter(self.disc_cfgs))].dtype
        if self.augment_backend == "device":
            batches = []
            for obj_id, start_idx, mask, image in objects:
                rng = np.random.RandomState(0)  # per-object reseed, as the reference
                with timer.phase("augment"):
                    batches.append(self.augmenter.augment_first_frame(
                        image, mask[..., None], rng,
                        image_dev=self._frame_dev(start_idx, chunks)))
        elif aug_batches is None:
            aug_batches = self._augment_objects(objects, timer)
        with timer.phase("disc_init"):
            f0 = [self._frame_dev(s, chunks) for s in start_frames]
            if self.augment_backend == "device":
                models = self._init_objects_dense(torch.stack([im for im, _ in batches]),
                                                  torch.stack([lb for _, lb in batches]))
                start_masks = torch.from_numpy(np.stack([o[2] for o in objects])).to(self.device)
            elif self.aug_compact:
                models, start_masks = self._init_objects_compact(f0, aug_batches)
            else:
                models, start_masks = self._init_objects(
                    f0, [a for a, _ in aug_batches], [b for _, b in aug_batches])

        # the windowed loop when re-solves provably fall on window ends
        # (every start frame = 0 mod train_skipping, or no online updates)
        W = max(int(self.disc_cfg.train_skipping), 1)
        aligned = (not self.disc_cfg.update_filters) or all(s % W == 0 for s in start_frames)
        track = self._window_track if aligned else self._scan_track
        with timer.phase("scan"):
            with count_host_syncs(self.device if self.profile else "cpu") as syncs:
                outs, self.last_models = track(feats_all, models, start_frames, start_masks,
                                               lut, im_size)
        self._scan_host_syncs = syncs
        if self.merge_mode == "online":
            return (frame0_label, outs)

        # deferred: whole-sequence merge with ground truth at the start frames
        with timer.phase("deferred_merge"):
            if soft:
                fg = torch.cat([torch.zeros_like(outs[:1]), outs])
                for k, start_idx in enumerate(start_frames):
                    fg[start_idx, k] = start_masks[k]
                return (fg,)
            return (self._merge_volume_windows(outs, start_frames, start_masks, lut, T),)
