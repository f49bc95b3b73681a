#!/usr/bin/env python3
"""Readings and times of the head conv's weight-gradient kernel
(csrc/conv3x3_cout1_dw.cu, frtm_conv3x3_cout1_dw_f32) on one CUDA card: what
the compiler made of it and how long it takes at the training shape.

    python3 scripts/bench_torch_conv3x3_dw.py                 # the source as it is
    python3 scripts/bench_torch_conv3x3_dw.py --parent DIR    # and a second tree's
    python3 scripts/bench_torch_conv3x3_dw.py --variants      # and VARIANTS below

DIR is the root of another checkout of the repository, of which only
frtm_tpu_torch/ops/kernels/csrc is read (for example a `git archive` of that
directory at the parent commit, unpacked into a directory that git ignores).
Each tree's conv3x3_cout1_dw.cu is built with the port's own nvcc flags into
build/conv3x3_dw/<tree>/ and bound with ctypes. Its entry point takes either
the floats per load and partials stored output by output (the streaming
design), or neither, with partials stored tile by tile (the design before
it); the script reads which from the source. With --variants, each entry of
VARIANTS is one more tree: the committed source with some text replaced
(the script fails if the text is no longer there).

Per tree it prints ptxas's registers, shared memory and spills and, where
the toolkit has cuobjdump, the SASS of every kernel function: its
instruction count and, for each innermost loop, its length and its
instructions by opcode. Then, at the training shape (x (16,16,480,854), dy
(16,1,480,854)) and at N = 8, each tree's gradient is held against the plain
backward (1e-4 of its peak; the committed tree's widths also bit for bit
against each other) and timed: device time per call from torch.profiler
(chip_smoke.device_ms) and CUDA events around batches of calls
(chip_smoke.event_ms), in two rounds, the second in the opposite tree order,
and split by kernel function (pass 1 and pass 2) from the profiler.
The committed kernel is also timed at its 4-byte width on x and dy aligned
and 4 bytes past an aligned pointer, and conv2d_weight + sum once per shape.
Prints one JSON line per reading and writes them all to
build/conv3x3_dw/results.json (or --out).
"""
import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import HBM_BYTES_PER_S, device_ms, event_ms, ptxas_functions  # noqa: E402
from bench_torch_bf16_decoder import cuobjdump, sass_readings  # noqa: E402
from frtm_tpu_torch.device import resolve_device  # noqa: E402
from frtm_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from frtm_tpu_torch.ops.kernels.conv3x3_cout1 import (  # noqa: E402
    _DW_ARGTYPES, conv3x3_cout1_weight_grad_plain, weight_grad_plan)

SHAPES = [(16, 16, 480, 854), (8, 16, 480, 854)]

_GROUP = "constexpr int kGroup = 4; "
_GROUPS = "constexpr int kGroups = 4; "
_WARPS = "constexpr int kWarpsX = 2; "

# variant -> [(committed text, replacement), ...]: a thread owns 2 channels,
# 8 groups share a block's dy rows (one warp each across 64 columns, so the
# block keeps 256 threads and 16 channels)
VARIANTS = {
    "group2": [(_GROUP, _GROUP.replace("4", "2")), (_GROUPS, _GROUPS.replace("4", "8")),
               (_WARPS, _WARPS.replace("2", "1"))],
}


def emit(obj, lines):
    lines.append(obj)
    print(json.dumps(obj), flush=True)


def variant_tree(tag, edits, out_root):
    """The committed csrc/ with one variant's edits, in out_root/src_<tag>."""
    out = out_root / f"src_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(kbuild.CSRC, out)
    path = out / "conv3x3_cout1_dw.cu"
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {tag}: no longer matches conv3x3_cout1_dw.cu: {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return out


def build_tree(tag, csrc, out_root, sass_dir=None):
    """(call(x, gy, out, vec) -> rc, streaming, ptxas, sass) of one tree; the
    whole SASS to sass_dir/<tag>.sass where it is given."""
    out = out_root / tag
    out.mkdir(parents=True, exist_ok=True)
    src = csrc / "conv3x3_cout1_dw.cu"
    lib_path = out / "libconv3x3_cout1_dw.so"
    p = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(csrc), "-o",
                        str(lib_path), str(src)], capture_output=True, text=True, timeout=600)
    log = p.stdout + p.stderr
    if p.returncode:
        raise RuntimeError(f"nvcc failed for {tag}/conv3x3_cout1_dw.cu:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    streaming = "int vec" in src.read_text()
    fn, blocks = lib.frtm_conv3x3_cout1_dw_f32, lib.frtm_conv3x3_cout1_dw_blocks
    blocks.restype = ctypes.c_longlong
    if streaming:
        fn.argtypes = _DW_ARGTYPES + [ctypes.c_int, ctypes.c_void_p]
        blocks.argtypes = [ctypes.c_int] * 5
    else:
        fn.argtypes = _DW_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
        blocks.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    scratch = {}

    def call(x, gy, out, vec=2):
        n, c, h, w = x.shape
        key = tuple(x.shape)
        if key not in scratch:
            tiles = blocks(n, c, h, w, 0) if streaming else blocks(n, h, w)
            scratch[key] = (tiles, torch.empty(tiles * (9 * c + 1), device="cuda"))
        tiles, partials = scratch[key]
        widths = (vec,) if streaming else ()
        return fn(x.data_ptr(), gy.data_ptr(), partials.data_ptr(), out.data_ptr(), tiles,
                  n, c, h, w, *widths, 0, stream)

    if sass_dir is not None and cuobjdump() is not None:
        sass_dir.mkdir(parents=True, exist_ok=True)
        (sass_dir / f"{tag}.sass").write_text(subprocess.run(
            [cuobjdump(), "-sass", str(lib_path)], capture_output=True, text=True,
            timeout=300).stdout)
    return call, streaming, ptxas_functions(log), sass_readings(lib_path)


def timed(call):
    return {"ms": device_ms(call), "event_ms": event_ms(call)}


def kernel_ms(call, iters=20):
    """{kernel name: device ms per call} from torch.profiler: pass 1 and
    pass 2 apart."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            t = getattr(ev, "device_time", None) or getattr(ev, "cuda_time", 0.0)
            out[ev.name] = out.get(ev.name, 0.0) + t / iters / 1e3
    return out


def offset_copy(t, offset):
    """t's values in a view `offset` floats past an aligned pointer."""
    view = torch.empty(t.numel() + offset, device="cuda")[offset:].view_as(t)
    view.copy_(t)
    return view


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of a second tree to compare with")
    ap.add_argument("--variants", action="store_true", help="also time VARIANTS")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "conv3x3_dw" / "results.json")
    ap.add_argument("--sass-dir", type=Path, help="write each tree's whole SASS there")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    resolve_device("cuda")
    lines = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}, lines)
    out_root = ROOT / "build" / "conv3x3_dw"
    trees = {"committed": kbuild.CSRC}
    if args.parent:
        trees = {"parent": args.parent / "frtm_tpu_torch" / "ops" / "kernels" / "csrc", **trees}
    if args.variants:
        trees.update({tag: variant_tree(tag, edit, out_root) for tag, edit in VARIANTS.items()})
    built, bad = {}, []
    for tag, csrc in trees.items():
        try:
            call, streaming, ptxas, sass = build_tree(tag, csrc, out_root, args.sass_dir)
        except RuntimeError as e:   # the other trees are still measured
            emit({"tree": tag, "build_error": str(e)[-6000:]}, lines)
            bad.append((tag, "build"))
            continue
        built[tag] = (call, streaming)
        emit({"tree": tag, "streaming": streaming, "ptxas": ptxas, "sass": sass}, lines)
    if "committed" not in built:
        raise SystemExit(f"failed: {bad}")
    order = list(built) + list(built)[::-1]
    g = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        n, c, h, w = shape
        x = torch.relu(torch.randn(shape, generator=g)).cuda()
        gy = (torch.randn(n, 1, h, w, generator=g) * 1e-3).cuda()
        pw, pb = conv3x3_cout1_weight_grad_plain(x, gy, (1, c, 3, 3))
        want = torch.cat([pw.flatten(), pb])
        peak = float(want.abs().max())
        ref = torch.empty_like(want)
        if built["committed"][0](x, gy, ref) != 0:
            raise SystemExit(f"committed kernel refused {shape}")
        line = {"shape": list(shape),
                "bound_ms": 4 * (x.numel() + gy.numel() + want.numel()) / HBM_BYTES_PER_S * 1e3,
                "rows": weight_grad_plan(n, c, h, w, x.device),
                "library": timed(lambda: torch.cat([
                    torch.nn.grad.conv2d_weight(x, (1, c, 3, 3), gy, padding=1).flatten(),
                    gy.sum().reshape(1)]))}
        for tag in order:
            call, streaming = built[tag]
            out = torch.full_like(want, float("nan"))
            if call(x, gy, out) != 0:
                raise SystemExit(f"{tag} refused {shape}")
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            r = line.setdefault(tag, {"max_abs_err": err, "ms": [], "event_ms": []})
            if not err <= 1e-4 * peak:
                bad.append((tag, shape, err, 1e-4 * peak))
            t = timed(lambda: call(x, gy, out))
            r["ms"].append(t["ms"])
            r["event_ms"].append(t["event_ms"])
            r.setdefault("kernels_ms", kernel_ms(lambda: call(x, gy, out)))
        call = built["committed"][0]
        for offset in (0, 1):       # 4-byte loads, aligned and 4 bytes past
            xv, gv = offset_copy(x, offset), offset_copy(gy, offset)
            out = torch.full_like(want, float("nan"))
            if call(xv, gv, out, 1) != 0:
                raise SystemExit(f"committed kernel refused v1 offset {offset} {shape}")
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                bad.append((f"committed v1 offset {offset}", shape))
            line[f"committed_v1_offset{offset}"] = timed(lambda: call(xv, gv, out, 1))
            del xv, gv
        for tag in built:
            r = line[tag]
            best = min([v for v in r["ms"] if v] or r["event_ms"])
            r["bound_share"] = line["bound_ms"] / best
            r["library_ratio"] = best / (line["library"]["ms"] or line["library"]["event_ms"])
        emit(line, lines)
        del x, gy
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(lines, indent=1))
    if bad:
        raise SystemExit(f"failed: {bad}")


if __name__ == "__main__":
    main()
