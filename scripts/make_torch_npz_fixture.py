#!/usr/bin/env python3
"""Write the `.npz` model fixture that the port's checks read
(tests/data/torch_fixtures/models/): a frtm_tpu model as its trainer and
evaluation CLIs store one, `save_pytree({"arch": "resnet18", "refiner": ...})`
of a seeded resnet18-width refiner (init_seg_network, PRNGKey(0)), written
by frtm_tpu's own `save_pytree` as rn18_refiner.npz beside its
rn18_refiner.treedef sidecar. The card's machine has no JAX to write one.

    python scripts/make_torch_npz_fixture.py [--out tests/data/torch_fixtures/models]
"""
import argparse
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" / "torch_fixtures" / "models"))
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from frtm_tpu.models import init_seg_network, resnet_out_channels
    from frtm_tpu.utils.checkpoints import save_pytree

    layers = ("layer5", "layer4", "layer3", "layer2")
    ch = {L: c for L, c in resnet_out_channels("resnet18").items() if L in layers}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    save_pytree(out / "rn18_refiner",
                {"arch": "resnet18", "refiner": init_seg_network(jax.random.PRNGKey(0), ch)})
    for f in sorted(out.glob("rn18_refiner.*")):
        print(f, f.stat().st_size, "bytes")


if __name__ == "__main__":
    main()
