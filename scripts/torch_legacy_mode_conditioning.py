"""How well conditioned the card test of the fused tracker's legacy modes is
(tests/test_torch_cuda.py::test_fused_tracker_legacy_modes_match_the_cpu_path).

For each fixture variant (mode, target-model layers, sequence seed, score
gain, entry frame of object 2) it runs the test's helper
`_legacy_mode_readings`: the deferred merge at 480x854 on the card and on the
CPU, and on the CPU again with the input features moved by 1e-6. It prints one JSON line per variant: the soft
volumes' largest gap and the labels' largest per-frame mismatch, card
against CPU and nudged CPU against CPU, the seconds it took, and whether the
two squares overlap in any frame. A fixture is well conditioned where the
nudge moves its labels far less than the card-against-CPU bound (0.5 % of a
frame).

    python scripts/torch_legacy_mode_conditioning.py [--fixtures]

Needs a CUDA card; imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OLD, NEW = ("layer4", "layer3"), ("layer5", "layer4")
VARIANTS = [  # keyword arguments of the test's helper, after the mode
    ("disc_layers", dict(seed=2, entry=None, layers=OLD)),
    ("disc_layers", dict(seed=2, entry=None, layers=OLD, score_gain=300.0)),
    ("disc_layers", dict(seed=4, entry=None, layers=OLD, score_gain=300.0)),
    ("disc_layers", dict(seed=5, entry=None, layers=OLD, score_gain=300.0)),
    ("disc_layers", dict(seed=2, entry=None, layers=OLD, score_gain=30.0)),
    ("disc_layers", dict(seed=2, entry=3, layers=OLD)),
    ("disc_layers", dict(seed=2, entry=3, layers=OLD, score_gain=300.0)),
    ("disc_layers", dict(seed=2, entry=None, layers=NEW)),
    ("disc_layers", dict(seed=4, entry=3, layers=NEW)),
    ("disc_layers", dict(seed=5, entry=3, layers=NEW)),
    ("disc_layers", dict(seed=2, entry=3, layers=NEW)),      # the test's fixture
    ("thresh", dict(seed=2, entry=3)),                          # the test's fixture
]


def squares_overlap(seed, n_frames=5):
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    seq = make_moving_square_sequence(n_frames=n_frames, size=(480, 854), square=120,
                                      n_objects=2, seed=seed)
    # object 2's square is drawn over object 1's where they meet
    return any(int((lb > 0).sum()) < 2 * 120 * 120 for lb in seq.labels)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fixtures", action="store_true",
                    help="only the two fixtures the test uses")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("test_torch_cuda",
                                                  ROOT / "tests" / "test_torch_cuda.py")
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    from frtm_tpu_torch.device import resolve_device
    resolve_device("cuda")
    for mode, kw in VARIANTS[-2:] if args.fixtures else VARIANTS:
        t0 = time.perf_counter()
        readings, _ = tests._legacy_mode_readings(mode, **kw)
        print(json.dumps(dict(mode=mode, **kw, overlap=squares_overlap(kw["seed"]), **readings,
                              seconds=round(time.perf_counter() - t0, 1))), flush=True)


if __name__ == "__main__":
    main()
