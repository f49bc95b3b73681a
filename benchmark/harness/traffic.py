"""The one generator of tracking traffic: a mix file (traffic/<mix>.json)
holds a table of sequences (name, frames, one (h, w) ellipse box per object)
at one frame size; this module turns it and a seed into the sequences a
window walks.

The seed fixes only the order of the walk and the pixels, never the table:
the sequences are dealt into balanced chunks of `chunk_sequences` (like
objects and frames in each), the walk cycles the chunks from one the seed
picks, in an order within each chunk that the seed shuffles. So every run
meets the same mix, and two seeds differ in what they see, not in how much.

Frames are textured ellipses moving over a textured background, every object
apart from the others in frame 0, where its label is given. The driver makes
all of a mix's frames in set-up (`make_all`); a sequence hands them over when
the tracker's loader asks (`preload`, on run_dataset's prefetch thread, where
a dataset on disk decodes its JPEGs) and drops them when the loop releases
them (`preloaded = None`).
"""
import json
from pathlib import Path

import numpy as np


def load_mix(path) -> dict:
    mix = json.loads(Path(path).read_text())
    for s in mix["sequences"]:
        if s["frames"] < 2 or not s["objects"]:
            raise ValueError(f"{path}: sequence {s['name']} needs 2 frames and an object")
    return mix


def _rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *keys])


def balanced_chunks(mix) -> list:
    """The table's indices dealt into chunks of chunk_sequences: largest
    first (objects, then frames), each to the chunk with room that holds the
    least work so far (frames plus 30 a object, an init's worth), so that
    every chunk holds a like share of objects and frames."""
    seqs = mix["sequences"]
    size = int(mix["chunk_sequences"])
    n_chunks = -(-len(seqs) // size)
    order = sorted(range(len(seqs)), key=lambda i: (-len(seqs[i]["objects"]),
                                                    -seqs[i]["frames"], i))
    chunks = [[] for _ in range(n_chunks)]
    work = [0] * n_chunks
    for i in order:
        k = min((k for k in range(n_chunks) if len(chunks[k]) < size),
                key=lambda k: (work[k], k))
        chunks[k].append(i)
        work[k] += seqs[i]["frames"] + 30 * len(seqs[i]["objects"])
    return chunks


def walk(mix, seed: int):
    """Endless chunks of table indices: the balanced chunks in turn, from
    the one the seed picks, each in an order the seed shuffles."""
    chunks = balanced_chunks(mix)
    rng = _rng(seed, 0)
    start = int(rng.integers(len(chunks)))
    lap = 0
    while True:
        for k in range(len(chunks)):
            chunk = list(chunks[(start + k) % len(chunks)])
            _rng(seed, 1, lap, k).shuffle(chunk)
            yield chunk
        lap += 1


class GeneratedSequence:
    """One sequence of a mix, with the interface of the port's dataset
    sequences: name, frame_names, start_frames, obj_ids, len, and
    seq[i] -> (image (H, W, 3) uint8, labels, entering object ids)."""

    merge_objects = False

    def __init__(self, spec: dict, size, seed: int, index: int, visit: int = 0, made=None):
        """made: {index: (frames, first labels)} made before the window
        (make_all), which `preload` takes instead of making them again."""
        self.spec = spec
        self.size = tuple(int(v) for v in size)
        self.seed, self.index = seed, index
        self.made = made
        # a sequence met again on a later lap keeps its pixels but not its name
        self.name = spec["name"] if visit == 0 else f"{spec['name']}.{visit}"
        self.frame_names = ["%05d" % i for i in range(spec["frames"])]
        self.obj_ids = list(range(1, len(spec["objects"]) + 1))
        self.start_frames = {"00000": list(self.obj_ids)}
        self._frames = None
        self._labels0 = None

    def __len__(self):
        return self.spec["frames"]

    @property
    def preloaded(self):
        return self._frames

    @preloaded.setter
    def preloaded(self, value):
        """The tracker's loop sets None to release the frames."""
        self._frames = value

    def preload(self):
        if self._frames is None:
            self._frames, self._labels0 = (self.made[self.index] if self.made is not None
                                           else make_frames(self.spec, self.size, self.seed,
                                                            self.index))

    def frames(self) -> np.ndarray:
        """All frames, (T, H, W, 3) uint8 (made again if released)."""
        self.preload()
        return self._frames

    def first_labels(self) -> np.ndarray:
        if self._labels0 is None:
            self._labels0 = make_frames(self.spec, self.size, self.seed, self.index,
                                        n_frames=1)[1]
        return self._labels0

    def __getitem__(self, i):
        self.preload()
        if i == 0:
            return self._frames[0], self._labels0, list(self.obj_ids)
        return self._frames[i], [], []


def make_all(mix, seed: int) -> dict:
    """Every table entry's (frames, first labels) under `seed`: made in
    set-up, so that the window's loader thread only hands them over and
    takes no interpreter time from the thread that drives the card."""
    size = tuple(mix["frame_size"])
    return {i: make_frames(s, size, seed, i) for i, s in enumerate(mix["sequences"])}


def _texture(rng, h, w, lo, hi, cell):
    """Blocky noise of `cell` px plus fine noise, (h, w, 3) uint8."""
    coarse = rng.integers(lo, hi, (h // cell + 1, w // cell + 1, 3), dtype=np.uint8)
    t = np.repeat(np.repeat(coarse, cell, axis=0), cell, axis=1)[:h, :w]
    return (t + rng.integers(0, 24, (h, w, 3), dtype=np.uint8)).astype(np.uint8)


def make_frames(spec: dict, size, seed: int, index: int, n_frames=None):
    """(frames (T, H, W, 3) uint8, frame 0's label image (H, W) uint8) of
    table entry `index` under `seed`. Objects are placed apart in frame 0
    (one cell each of a grid over the frame) and move 1-4 px a frame,
    bouncing off the edges; later objects are drawn over earlier ones."""
    H, W = size
    T = spec["frames"] if n_frames is None else n_frames
    rng = _rng(seed, 2, index)
    bg = _texture(rng, H, W, 30, 130, 8)
    boxes = [tuple(int(v) for v in b) for b in spec["objects"]]
    n = len(boxes)
    cols = int(np.ceil(np.sqrt(n * W / H)))
    rows = -(-n // cols)
    cells = rng.permutation(rows * cols)[:n]
    objs = []
    for k, (h, w) in enumerate(boxes):
        r, c = divmod(int(cells[k]), cols)
        cy = (r + 0.5) * H / rows
        cx = (c + 0.5) * W / cols
        y0 = float(np.clip(cy - h / 2, 0, H - h))
        x0 = float(np.clip(cx - w / 2, 0, W - w))
        v = rng.uniform(1.0, 4.0, 2) * rng.choice([-1.0, 1.0], 2)
        yy, xx = np.mgrid[:h, :w]
        inside = ((yy + 0.5 - h / 2) / (h / 2)) ** 2 + ((xx + 0.5 - w / 2) / (w / 2)) ** 2 <= 1
        objs.append(dict(pos=[y0, x0], v=v, h=h, w=w, mask=inside,
                         tex=_texture(rng, h, w, 120, 250, 6)))
    frames = np.empty((T, H, W, 3), np.uint8)
    labels0 = np.zeros((H, W), np.uint8)
    for t in range(T):
        frames[t] = bg
        for k, o in enumerate(objs):
            y0, x0 = int(o["pos"][0]), int(o["pos"][1])
            view = frames[t, y0:y0 + o["h"], x0:x0 + o["w"]]
            view[o["mask"]] = o["tex"][o["mask"]]
            if t == 0:
                labels0[y0:y0 + o["h"], x0:x0 + o["w"]][o["mask"]] = k + 1
            for d, lim in ((0, H - o["h"]), (1, W - o["w"])):
                o["pos"][d] += o["v"][d]
                if not 0 <= o["pos"][d] <= lim:
                    o["v"][d] = -o["v"][d]
                    o["pos"][d] = float(np.clip(o["pos"][d], 0, lim))
    return frames, labels0
