"""Synthetic "moving square" sequences (frtm_tpu/data/synthetic.py): the
fixture that replaces DAVIS data where no dataset is present. Same
generator, same values for a given seed."""
import numpy as np


class SyntheticSequence:
    """In-memory sequence: name, obj_ids, frame_names, start_frames, and
    indexing -> (image (H, W, 3) uint8, labels, new object ids)."""

    def __init__(self, name, images, labels, start_frames):
        self.name = name
        self.images = images
        self.labels = labels
        self.start_frames = start_frames
        self.obj_ids = sorted({int(v) for lb in labels for v in np.unique(lb) if v != 0})
        self.frame_names = ["%05d" % i for i in range(len(images))]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        new_objects = self.start_frames.get(self.frame_names[i], [])
        lb = []
        if new_objects:
            # labels of objects outside their start frame are suppressed
            lb = self.labels[i]
            keep = set([0] + list(new_objects))
            for o in [int(o) for o in np.unique(lb) if int(o) not in keep]:
                lb = np.where(lb == o, 0, lb).astype(lb.dtype)
        return self.images[i], lb, list(new_objects)


def make_moving_square_sequence(n_frames=12, size=(120, 160), square=28,
                                n_objects=1, seed=0, name="synth"):
    """Textured squares moving over a textured background; object k has
    label k+1. Deterministic for a given seed."""
    rng = np.random.RandomState(seed)
    H, W = size
    bg = (rng.rand(H, W, 3) * 80 + 40).astype(np.uint8)
    textures = [(rng.rand(square, square, 3) * 120 + 120).astype(np.uint8)
                for _ in range(n_objects)]
    pos0 = [(rng.randint(0, H - square), rng.randint(0, W - square)) for _ in range(n_objects)]
    vel = [(rng.randint(1, 4), rng.randint(1, 4)) for _ in range(n_objects)]

    images, labels = [], []
    for t in range(n_frames):
        im = bg.copy()
        lb = np.zeros((H, W, 1), np.uint8)
        for k in range(n_objects):
            r = int(np.clip(pos0[k][0] + vel[k][0] * t, 0, H - square))
            c = int(np.clip(pos0[k][1] + vel[k][1] * t, 0, W - square))
            im[r:r + square, c:c + square] = textures[k]
            lb[r:r + square, c:c + square, 0] = k + 1
        images.append(im)
        labels.append(lb)
    return SyntheticSequence(name, images, labels, {"00000": list(range(1, n_objects + 1))})
