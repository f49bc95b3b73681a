"""The readings behind the training parity tests' bounds, on the CPU.

Prints one JSON line per reading:
  * decoder: for the frames of tests/test_torch_train_decoder.py drawn from
    seeds 5 to 11, the least ReLU input of the port's forward (over its
    tensor's peak) and the largest gap between the port's and frtm_tpu's
    gradients (over each parameter's peak; the conv biases before a
    batch-statistics BatchNorm, whose exact gradient is 0, left out);
  * train_step: for tests/test_torch_trainer.py's masked step, the loss gap
    and each parameter's gradient gap, worst first;
  * three_epochs: both trainers' per-epoch losses on that test's run;
  * cubic: the share of values where the port's cubic resize differs from
    cv2.resize (always by one grey level) on the loaders' shapes.

    python scripts/torch_train_parity_readings.py [--skip-epochs]

Needs JAX, cv2 and the test files; about 3 minutes.
"""
import argparse
import contextlib
import importlib.util
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fixture(f, *args):
    return f._get_wrapped_function()(*args) if hasattr(f, "_get_wrapped_function") \
        else f.__wrapped__(*args)


def decoder_readings():
    import pytest
    T = load("test_torch_train_decoder")
    for seed in range(5, 12):
        T.SEED = seed
        world = fixture(T.world)
        net = T.SegNetwork(T.CH)
        net.load_state_dict(T.seg_network_from_jax(world["tree"]))
        mp = pytest.MonkeyPatch()
        margin, n = T.relu_margin(net, world, mp)
        mp.undo()
        total, _, _ = T._run(net, world)
        total.backward()
        gap = max(float(np.abs(p.grad.numpy() - world["grads"][k].numpy()).max()
                        / np.abs(world["grads"][k].numpy()).max())
                  for k, p in net.named_parameters() if not k.endswith("bblock.0.bias"))
        print(json.dumps({"reading": "decoder", "seed": seed, "relu_margin": margin,
                          "relu_inputs": n, "grad_gap_of_peak": gap}), flush=True)


def trainer_readings(skip_epochs):
    T = load("test_torch_trainer")
    weights = fixture(T.weights)

    class Factory:
        def mktemp(self, name):
            return Path(tempfile.mkdtemp(prefix=name))

    w = fixture(T.step_world, weights, Factory())
    tm = T.port_model(weights)
    total, acc = tm.loss(T.to_port(w["jdisc"]), w["images"], w["labels"], w["mask"])
    total.backward()
    gaps = {k: float(np.abs(p.grad.numpy() - w["grads"][k].numpy()).max()
                     / np.abs(w["grads"][k].numpy()).max())
            for k, p in tm.refiner.named_parameters() if not k.endswith("bblock.0.bias")}
    worst = sorted(gaps, key=gaps.get, reverse=True)
    print(json.dumps({"reading": "train_step",
                      "loss_rel_gap": abs(float(total.detach()) / 2 - w["loss"]) / w["loss"],
                      "acc_rel_gap": abs(float(acc) - w["acc"]) / max(w["acc"], 1e-12),
                      "grad_gap_of_peak": {k: gaps[k] for k in worst[:8]},
                      "grad_gap_others_max": gaps[worst[8]] if len(worst) > 8 else None}),
          flush=True)
    if skip_epochs:
        return
    import torch
    from frtm_tpu.runtime import trainer as jt
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        tmp = Path(tmp)
        tr = T.Trainer("t1", T.port_model(weights), [lambda: T.SyntheticTrainingDataset(
            n_samples=8, size=(96, 128), sample_size=3, seed=0)], tmp / "c", tmp / "l",
            max_epochs=3, batch_size=4, load_latest=False, rng=np.random.RandomState(0))
        tr.train()
        jtr = jt.Trainer("t1", T.jax_model(weights), [lambda: T.JaxSynthetic(
            n_samples=8, size=(96, 128), sample_size=3, seed=0)], tmp / "jc", tmp / "jl",
            max_epochs=3, batch_size=4, load_latest=False)
        np.random.seed(0)
        jtr.train()
        losses = [json.loads(x)["stats/loss"] for x in open(tmp / "l" / "t1" / "stats.jsonl")]
        jlosses = [json.loads(x)["stats/loss"] for x in open(tmp / "jl" / "t1" / "stats.jsonl")]
    del torch
    print(json.dumps({"reading": "three_epochs", "port": losses, "jax": jlosses,
                      "rel_gap": [abs(a - b) / b for a, b in zip(losses, jlosses)]}), flush=True)


def cubic_readings():
    import cv2
    from frtm_tpu_torch.data import resize_host as R
    rng = np.random.RandomState(0)
    for src in [(360, 640), (240, 427), (300, 500), (720, 1280), (37, 53)]:
        dst = (480, 854) if src != (37, 53) else (20, 31)
        im = rng.randint(0, 256, src + (3,)).astype(np.uint8)
        gap = np.abs(R.resize_cubic(im, dst).astype(np.int64)
                     - cv2.resize(im, dst[::-1], interpolation=cv2.INTER_CUBIC))
        print(json.dumps({"reading": "cubic", "src": src, "dst": dst, "max": int(gap.max()),
                          "unequal_share": float((gap > 0).mean())}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-epochs", action="store_true", help="leave out the 3-epoch runs")
    args = ap.parse_args()
    import conftest  # noqa: F401  (JAX on the CPU, highest matmul precision)
    import torch
    torch.set_num_threads(4)
    cubic_readings()
    decoder_readings()
    trainer_readings(args.skip_epochs)


if __name__ == "__main__":
    main()
