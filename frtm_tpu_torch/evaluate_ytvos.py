"""Track YouTube-VOS 2018 valid_all_frames with the legacy configuration: the
port's counterpart of the JAX package's evaluate_ytvos_valid_all_frames.py,
with its command-line surface.

    python -m frtm_tpu_torch.evaluate_ytvos --model rn101_ytvos.pth \\
        --yt2018 /data/ytvos2018 --backbone resnet101.pth --output results

The legacy settings (per-frame hinge pixel weighting, update_method
"thresh", CG forgetting rate 75, memory 80, no clamping) drive the fused
tracker in its deferred merge mode: objects enter at the frames meta.json
names, the raw per-object soft masks are merged once over the whole
sequence with the ground truth inserted at the start frames. Indexed PNGs
go to <output>/ytvos2018valid_all_frames/Annotations/<sequence>/.

It runs on the card (`--dev cuda`, the default) and exits with an error where
there is none; `--dev cpu` must be asked for. `--model` takes a
reference-format .pth or a frtm_tpu `.npz` model, as the JAX package's CLI
does.
"""
import argparse
from dataclasses import replace
from pathlib import Path

from .evaluate import load_models


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m frtm_tpu_torch.evaluate_ytvos",
                                 description="Evaluate on YouTubeVOS 2018 valid_all_frames "
                                             "(legacy config; PyTorch / CUDA port)")
    ap.add_argument("--model", type=str, required=True,
                    help="refiner weights: a reference-format .pth")
    ap.add_argument("--yt2018", type=str, default="/data/ytvos2018", help="YouTubeVOS 2018 root")
    ap.add_argument("--output", type=str, default="results", help="output root")
    ap.add_argument("--backbone", type=str, default=None,
                    help="torchvision-format resnet .pth")
    ap.add_argument("--dev", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="device to run on; cuda needs a card, there is no fallback")
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                    help="backbone/refiner compute dtype")
    ap.add_argument("--sequences", nargs="*", default=None,
                    help="track only these sequences")
    return ap


def legacy_config(arch: str, compute_dtype: str):
    """The eval configuration with the legacy stack's target-model settings."""
    from .config import eval_config
    cfg = eval_config(arch, fast=False, compute_dtype=compute_dtype)
    return replace(cfg, disc=replace(
        cfg.disc, cg_forgetting_rate=75, pixel_weighting_method="hinge",
        pixel_weighting_tf=0.1, pixel_weighting_per_frame=True, distractor_mult=1.0,
        update_method="thresh", clamp_output=False))


def main(argv=None, dataset=None):
    """Run the tracking. `dataset`: a dataset object to track in place of the
    valid_all_frames split under --yt2018. Returns the results directory,
    the average fps and the tracker."""
    args = build_parser().parse_args(argv)
    _, arch, refiner, backbone = load_models(args)

    from .data.datasets import YouTubeVOSDataset
    from .runtime.sequence_tracker import BatchedSequenceTracker

    cfg = legacy_config(arch, args.dtype)
    tracker = BatchedSequenceTracker(cfg, backbone, refiner, merge_mode="deferred",
                                     device=args.dev)
    dset = dataset if dataset is not None else YouTubeVOSDataset(
        path=args.yt2018, year="2018", split="valid_all_frames", sequences=args.sequences)
    out_root = Path(args.output).expanduser().resolve() / "ytvos2018valid_all_frames" \
        / "Annotations"
    fps = tracker.run_dataset(dset, out_root)
    return {"out_path": out_root, "fps": fps, "tracker": tracker}


if __name__ == "__main__":
    main()
