"""Multi-sequence inference (frtm_tpu/parallel/multi_sequence.py): groups of
independent sequences tracked together, one group per card.

The JAX package stacks sequences on a batch axis sharded over a device mesh
and `jax.vmap`s its scan over it. The port gives the fused tracker's loop an
explicit sequence axis instead (BatchedSequenceTracker._track, as it has one
for objects): B sequences' frames go side by side, frame-major, and their
B x n object lanes, sequence-major, take one classify, one decode, one merge
and one set of memory inserts per window for all B, so kernels 1 and 2
launch as often for a group as for one sequence. The refiner is shared; the
features, target models, start frames, start masks and label tables are per
sequence.

Grouping, as in the JAX package: sequences are grouped by (image size,
length bucket, object count padded to a power of two). A sequence with fewer
objects pads its lanes with a start frame past the end (never tracked), a
zero start mask, background in its label table and the last real lane's
model; a sequence shorter than the group's longest repeats its last frame,
and its outputs there are dropped. Nothing is compiled per shape, so the
port tracks the group's longest sequence and no further, and needs no slot
padding in the init.

Across processes: each chunk of `mesh.size * chunk_multiple` sequences is
split by `batch_rows`, and rank r tracks its contiguous rows as one group on
its card and writes their PNGs. Nothing is communicated inside the loop.
"""
import dataclasses
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..data.image import LabelWriter, imwrite_indexed
from ..runtime.sequence_tracker import BatchedSequenceTracker
from ..utils.prefetch import prefetch_iter
from ..utils.profiling import PhaseTimer
from .distributed import batch_rows


def take_lanes(tree, index, index_dev):
    """The lanes `index` (host ints; `index_dev` the same on the device) of
    target models: every tensor along its object axis, and the host's
    per-lane frame counters."""
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, index_dev)
    if isinstance(tree, list):          # DiscState.frame_num
        return [tree[i] for i in index]
    if isinstance(tree, dict):          # multilayer models, by layer
        return {k: take_lanes(v, index, index_dev) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: take_lanes(getattr(tree, f.name), index,
                                                               index_dev)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):         # DiscParams, CG blocks, (params, states)
        items = [take_lanes(t, index, index_dev) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    raise TypeError(f"take_lanes: {type(tree).__name__}")


class ShardedSequenceTracker(BatchedSequenceTracker):
    """Tracks groups of sequences, each group in one pass over a sequence
    axis; a mesh of several processes splits every chunk between them."""

    def __init__(self, cfg, backbone, refiner, mesh, extract_chunk: int = 8,
                 merge_mode: str = "online", length_bucket: int = 32, decode_chunk=None,
                 device=None, **kwargs):
        """decode_chunk: None is 0, the whole window of B x w x n lanes in
        one decode, as the JAX package has it off the TPU. The compact
        augment stays off, as in the JAX class. kwargs (disc_params0,
        augmenter, profile) as for BatchedSequenceTracker."""
        super().__init__(cfg, backbone, refiner, extract_chunk=extract_chunk,
                         merge_mode=merge_mode,
                         decode_chunk=0 if decode_chunk is None else decode_chunk,
                         aug_compact=False, device=device, **kwargs)
        self.mesh = mesh
        self.length_bucket = length_bucket
        self.n_devices = mesh.size

    def _own_rows(self, batch):
        """This rank's contiguous rows of a chunk (batch_rows over the chunk
        padded to a multiple of the mesh; the padding is nobody's)."""
        padded = -(-len(batch) // self.n_devices) * self.n_devices
        lo, hi = batch_rows(padded, self.mesh.rank, self.n_devices)
        return batch[lo:hi]

    # ------------------------------------------------------------------

    def run_sequences(self, sequences):
        """Track many sequences; returns {name: [(H, W) uint8 labels]} of
        this rank's sequences (all of them in a world of one). Holds every
        prepared sequence and every result in memory; run_dataset streams."""
        groups = defaultdict(list)
        for seq in sequences:
            groups[self._group_key_meta(seq)].append(seq)
        results = {}
        for key, members in groups.items():
            mine = self._own_rows(members)
            if mine:
                results.update(self._run_group([(s, self._prepare(s)) for s in mine], key))
        return results

    def _group_key_meta(self, sequence):
        """The group key from the sequence's metadata (one frame decoded for
        the image size), so that run_dataset groups without preparing."""
        im_size = tuple(np.asarray(sequence[0][0]).shape[:2])
        n_track = len(sequence) - 1
        bucket_T = -(-n_track // self.length_bucket) * self.length_bucket
        n_pad = 1 << (len(sequence.obj_ids) - 1).bit_length()
        return (im_size, bucket_T, n_pad)

    def run_dataset(self, dataset, out_path, speedrun=False, restart=None, chunk_multiple=1,
                    pipeline=False):
        """Streaming dataset evaluation, memory bounded to one chunk (and
        the labels of the LabelWriter's DEPTH sequences): groups the
        sequences by their metadata, then per chunk of
        `n_devices * chunk_multiple` sequences of a group, this rank's rows:
        prepare, track, hand the labels to the writer, release, before the
        next chunk; the writer's threads write the PNGs meanwhile, all of
        them before this returns.

        speedrun: before the clock, one member of each (group key, width)
        is prepared once and tracked at that width (first launches and the
        convolution algorithms' choice; nothing is compiled). pipeline=True
        prepares the next chunk (decode, uploads, augment) on a background
        thread and the tracker's prep stream while this one tracks; the
        outputs are the same. Returns the aggregate fps."""
        out_path = Path(out_path)
        groups = defaultdict(list)
        skipping = restart is not None
        for sequence in dataset:
            if skipping:
                if sequence.name != restart:
                    continue
                skipping = False
            groups[self._group_key_meta(sequence)].append(sequence)

        chunk = max(1, self.n_devices * chunk_multiple)
        jobs = [(key, mine) for key, members in groups.items()
                for lo in range(0, len(members), chunk)
                for mine in [self._own_rows(members[lo:lo + chunk])] if mine]
        stream = self._prep_stream if pipeline else None

        def prep_chunk(batch):
            return [(seq, self._prepare(seq, stream=stream)) for seq in batch]

        if speedrun:
            warmed = set()
            for key, batch in jobs:
                if (key, len(batch)) in warmed:
                    continue
                warmed.add((key, len(batch)))
                preps = prep_chunk(batch[:1]) * len(batch)
                self._run_group(preps, key, as_device=self.merge_mode == "online")
                self._synchronize()
                del preps
            print(f"speedrun: warmed {len(warmed)} group program(s) pre-clock")

        t0 = time.perf_counter()
        n_frames = 0
        seq_fps = []    # per sequence: frames / its chunk's wall
        # each chunk's PNGs are written while the next one tracks; the writer
        # looks imwrite_indexed up here at each call
        with LabelWriter(lambda path, labels: imwrite_indexed(path, labels)) as writer:
            for (key, batch), preps in prefetch_iter(((j, prep_chunk(j[1])) for j in jobs),
                                                     enabled=pipeline):
                tc = time.perf_counter()
                results = self._run_group(preps, key)
                chunk_wall = max(time.perf_counter() - tc, 1e-9)
                del preps
                for seq in batch:
                    dst = out_path / seq.name
                    dst.mkdir(exist_ok=True, parents=True)
                    writer.put(dst, results[seq.name], seq.frame_names)
                    n_frames += len(seq)
                    seq_fps.append(len(seq) / chunk_wall)
                    print(f"{seq.name}: {len(seq)} frames written")
                    if getattr(seq, "preloaded", None) is not None:
                        seq.preloaded = None    # release decoded frames
                del results
        fps = n_frames / max(time.perf_counter() - t0, 1e-9)
        # two fps, labelled so that they are never compared: the aggregate is
        # throughput (all frames over the whole wall, host prep included);
        # the per-sequence mean is frames over its chunk's tracking wall
        # (prep excluded in both pipeline modes), about 1 / B of the
        # aggregate: a latency, not comparable to the fused engine's fps
        print("Sharded dataset pass: %.2f fps aggregate (all sequences / total wall)" % fps)
        if seq_fps:
            print("Sharded dataset pass: %.2f fps per-sequence mean (completion rate, ex-prep; "
                  "chunks of %d run concurrently)" % (float(np.mean(seq_fps)), chunk))
        return fps

    def _prepare(self, sequence, preloaded=None, stream=None):
        """Host-side per-sequence prep: frames and their upload (or
        `preloaded`, a prepare_inputs() result), objects, first-frame
        augment batches (each object reseeded, RandomState(0)) and the
        group key. The init solves wait for _run_group, which takes every
        object of the group in one."""
        prep = self.prepare_sequence(sequence, stream, inputs=preloaded)
        if not prep["objects"]:
            raise ValueError(f"sequence {sequence.name!r} has no objects")
        n_track = len(prep["images_np"]) - 1
        bucket_T = -(-n_track // self.length_bucket) * self.length_bucket
        n_pad = 1 << (len(prep["objects"]) - 1).bit_length()
        im_size = tuple(prep["images_np"].shape[1:3])
        prep.update(n_track=n_track, bucket_T=bucket_T, n_pad=n_pad, im_size=im_size,
                    group_key=(im_size, bucket_T, n_pad))
        return prep

    def _extract_group(self, preps, T):
        """{layer: (T * B, c, h, w)}: frames 1..T of each sequence,
        frame-major, in chunks of extract_chunk frames; a sequence shorter
        than T repeats its last frame."""
        t = torch.arange(T, device=self.device)
        frames = []
        for prep in preps:
            own = torch.cat(prep["chunks"])
            frames.append(own[t.clamp(max=own.shape[0] - 1)])
        frames = torch.stack(frames, dim=1).flatten(0, 1)
        C = self.extract_chunk
        return self._extract_sequence([frames[i:i + C] for i in range(0, frames.shape[0], C)])

    @torch.no_grad()
    def _run_group(self, seq_preps, key, as_device=False, timer=None):
        """Track one group of prepared sequences [(sequence, prep)] in one
        pass: one backbone pass over their frames, one init of every object
        of every sequence, one loop over the sequence axis (windowed when
        every object starts on a window boundary, else per frame). Returns
        {name: [(H, W) uint8 labels]}; as_device=True (online merge only)
        returns the (B, T', H, W) uint8 label volume on the card instead,
        not downloaded. The deferred merge runs per sequence on the card,
        over that sequence's lanes with its own labels (the fused tracker's
        _merge_volume_windows), before the download. timer (a PhaseTimer)
        takes the phases group_feats, group_init and group_scan."""
        timer = timer or PhaseTimer(sync=False)
        im_size, _, n = key
        B = len(seq_preps)
        dev = self.device
        preps = [prep for _, prep in seq_preps]
        for prep in preps:
            self._adopt(prep)
        T = max(prep["n_track"] for prep in preps)
        # lane b * n + j: object j of sequence b, or a pad lane that repeats
        # the sequence's last object and never starts
        start_frames, index, real, first = [], [], [], 0
        luts = np.zeros((B, n + 1), np.int32)
        for b, prep in enumerate(preps):
            k = len(prep["objects"])
            if k > n:
                raise ValueError(f"sequence {seq_preps[b][0].name!r} has {k} objects, its "
                                 f"group {n}: its start frames and obj_ids disagree")
            start_frames += [o[1] for o in prep["objects"]] + [T + 1] * (n - k)
            index += [first + min(j, k - 1) for j in range(n)]
            real += [j < k for j in range(n)]
            luts[b, 1:k + 1] = [o[0] for o in prep["objects"]]
            first += k
        lut = torch.from_numpy(luts).to(dev)

        if T == 0:      # nothing to track: the outputs are the start labels
            labels = [self._frame0_label(p["objects"], im_size) for p in preps]
            return {s.name: [lb] for (s, _), lb in zip(seq_preps, labels)}
        with timer.phase("group_feats"):
            feats = self._extract_group(preps, T)
        with timer.phase("group_init"):
            f0 = [self._frame_dev(o[1], p["chunks"], p["frame0_dev"])
                  for p in preps for o in p["objects"]]
            batches = [a for p in preps for a in p["aug_batches"]]
            models, masks = self._init_objects(f0, [a for a, _ in batches],
                                               [b for _, b in batches])
            if not all(real):
                index_dev = torch.tensor(index, device=dev)
                models = take_lanes(models, index, index_dev)
                masks = masks.index_select(0, index_dev) * torch.tensor(
                    real, device=dev)[:, None, None]
        w = max(int(self.disc_cfg.train_skipping), 1)
        windowed = (not self.disc_cfg.update_filters) or all(
            o[1] % w == 0 for p in preps for o in p["objects"])
        with timer.phase("group_scan"):
            outs, self.last_models = self._track(feats, models, start_frames, masks, lut,
                                                 im_size, window=w if windowed else 1,
                                                 n_seqs=B)
        del feats
        if self.merge_mode == "online":
            labels = outs.view(T, B, *im_size).transpose(0, 1)
            if as_device:
                return labels
            labels = labels.cpu().numpy()
            return {s.name: [self._frame0_label(p["objects"], im_size)]
                    + list(labels[b, :p["n_track"]])
                    for b, (s, p) in enumerate(seq_preps)}
        if as_device:
            raise ValueError("as_device returns the online merge's labels only")
        results = {}
        for b, (sequence, prep) in enumerate(seq_preps):
            k = len(prep["objects"])
            lanes = slice(b * n, b * n + k)
            merged = self._merge_volume_windows(
                outs[:prep["n_track"], lanes], [o[1] for o in prep["objects"]], masks[lanes],
                lut[b, :k + 1], prep["n_track"] + 1)
            results[sequence.name] = list(merged.cpu().numpy())
        return results
