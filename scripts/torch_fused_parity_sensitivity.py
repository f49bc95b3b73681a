#!/usr/bin/env python3
"""Where the tolerance of tests/test_torch_sequence_tracker.py's deferred soft
volume comes from, on the CPU (JAX_PLATFORMS=cpu), at that test's fixture:

  1. frtm_tpu's two-object soft volume with its augmenter's reused buffers
     64-byte aligned and not, behind the tests' FreshBatches and without it
     (on the CPU backend `jnp.asarray` aliases an aligned numpy buffer, so
     the unprotected aligned run feeds object 1's init from object 2's
     augmentation);
  2. the port's volume against frtm_tpu's, per frame;
  3. frtm_tpu's own sensitivity: how far its volume moves when its input
     features move by 1e-6 and 1e-5 (relative; the stem convolution scaled).

    JAX_PLATFORMS=cpu python scripts/torch_fused_parity_sensitivity.py
"""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import test_torch_sequence_tracker as fixture  # noqa: E402


def main():
    world = fixture.World()
    seq = fixture._sequence(6, 2)
    K = world.jcfg.aug_params["num_aug"]

    def run(tracker, offset):
        aug = getattr(tracker.augmenter, "inner", tracker.augmenter)
        aug._buf_key = (K,) + fixture.SIZE
        aug._buf_im = fixture._buffer_at((K,) + fixture.SIZE + (3,), offset)
        aug._buf_lb = fixture._buffer_at((K,) + fixture.SIZE + (1,), offset)
        return tracker.run_sequence(seq, soft=True)[0]

    def per_frame(a, b):
        return [float(np.abs(a[t] - b[t]).max()) for t in range(len(a))]

    protected = world.jax("deferred")
    a, b = run(protected, 0), run(protected, 1)
    print("protected, aligned vs unaligned buffers:", float(np.abs(a - b).max()))
    bare = fixture.JaxFused(world.jcfg, world.backbone, world.refiner, extract_chunk=4,
                            scan_bucket=8, merge_mode="deferred")
    c, d = run(bare, 0), run(bare, 1)
    print("unprotected, aligned vs unaligned:", float(np.abs(c - d).max()),
          "; unaligned vs protected:", float(np.abs(d - a).max()))
    got = world.port("deferred").run_sequence(seq, soft=True)[0]
    print("port vs frtm_tpu, per frame:", per_frame(got, a))
    for eps in (1e-6, 1e-5):
        backbone = dict(world.backbone)
        backbone["conv1"] = world.backbone["conv1"] * (1 + eps)
        moved = fixture.JaxFused(world.jcfg, backbone, world.refiner, extract_chunk=4,
                                 scan_bucket=8, merge_mode="deferred")
        moved.augmenter = fixture.FreshBatches(moved.augmenter)
        print(f"frtm_tpu, features moved by {eps:g}, per frame:", per_frame(run(moved, 1), a))


if __name__ == "__main__":
    main()
