#!/usr/bin/env python3
"""Readings and times of pyrup's backward kernel (csrc/pyrup_bwd.cu,
frtm_pyrup_bwd_f32) on one CUDA card: what the compiler made of it and how
long it takes at the training shapes.

    python3 scripts/bench_torch_pyrup_bwd.py                 # the source as it is
    python3 scripts/bench_torch_pyrup_bwd.py --parent DIR    # and a second tree's
    python3 scripts/bench_torch_pyrup_bwd.py --variants      # and VARIANTS below

DIR is the root of another checkout of the repository, of which only
frtm_tpu_torch/ops/kernels/csrc is read (for example a `git archive` of that
directory at the parent commit, unpacked into a directory that git ignores).
Each tree's pyrup_bwd.cu is built with the port's own nvcc flags into
build/pyrup_bwd/<tree>/ and bound with ctypes. Its entry point takes either
the tables of pyrup.py (PYRDOWN_TAPS, FOLD_FIRST, FOLD_LAST) and the floats
per load, or, in a source from before those, the even and odd taps; the
script reads which from the source. With --variants, each entry of VARIANTS
is one more tree: the committed source with some text replaced (the script
fails if the text is no longer there; every occurrence is replaced).

Per tree it prints ptxas's registers, shared memory and spills and, where
the toolkit has cuobjdump, the SASS of every kernel function: its
instruction count and, for each innermost loop, its length and its
instructions by opcode. Then, at the training shapes (N = 16, both pyrup
stages: (16,32,120,214) and (16,16,240,428)), each tree's gradient is held
against the plain backward (1e-5 of its peak; trees of the committed
tables also bit for bit against the committed kernel) and timed: device time
per call from torch.profiler (chip_smoke.device_ms) and CUDA events around
batches of calls (chip_smoke.event_ms), in two rounds, the second in the
opposite tree order. The committed kernel is also timed at its 8- and 4-byte
widths, on gy aligned and 8 and 4 bytes past an aligned pointer, and
upsample_bicubic2d_backward once per shape. Prints one JSON line per reading
and writes them all to build/pyrup_bwd/results.json (or --out).
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
from frtm_tpu_torch.ops.kernels.pyrup import (_BWD_ARGTYPES, _BWD_TAPS_C,  # noqa: E402
                                              _TAPS_C, pyr_up_bicubic_backward_plain)

SHAPES = [(16, 32, 120, 214), (16, 16, 240, 428)]
# (floats per load, gy offset in floats) of the committed kernel's extra rows
WIDTHS = [(2, 0), (2, 2), (1, 1)]

_AHEAD = "constexpr int kAhead = 1;"
_ROWS = "constexpr int kMaxRows = 8; "
_BOUNDS = "__global__ void __launch_bounds__(kThreads)"
_THREADS = "constexpr int kThreads = 128;"


def _rows(n):
    return (_ROWS, _ROWS.replace("8; ", f"{n};"))


def _min_blocks(n):
    return (_BOUNDS, _BOUNDS.replace("(kThreads)", f"(kThreads, {n})"))


# variant -> [(committed text, replacement), ...]
VARIANTS = {
    "ahead2": [(_AHEAD, _AHEAD.replace("1", "2"))], "rows16": [_rows(16)],
    "rows32": [_rows(32)], "ahead2_rows16": [(_AHEAD, _AHEAD.replace("1", "2")), _rows(16)],
    "minblocks8": [_min_blocks(8)], "threads256": [(_THREADS, _THREADS.replace("128", "256"))],
    "ldca": [("__ldg(", "__ldca(")],
}


def emit(obj, lines):
    lines.append(obj)
    print(json.dumps(obj), flush=True)


def variant_tree(tag, edits, out_root):
    """The committed csrc/ with one variant's edits, in out_root/src_<tag>."""
    out = out_root / f"src_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(kbuild.CSRC, out)
    path = out / "pyrup_bwd.cu"
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {tag}: no longer matches pyrup_bwd.cu: {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return out


def build_tree(tag, csrc, out_root, sass_dir=None):
    """(call(gy, gx, shape, vec) -> rc, tables, ptxas, sass) of one tree;
    the whole SASS to sass_dir/<tag>.sass where it is given."""
    out = out_root / tag
    out.mkdir(parents=True, exist_ok=True)
    src = csrc / "pyrup_bwd.cu"
    lib = out / "libpyrup_bwd.so"
    p = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
                        str(src)], capture_output=True, text=True, timeout=600)
    log = p.stdout + p.stderr
    if p.returncode:
        raise RuntimeError(f"nvcc failed for {tag}/pyrup_bwd.cu:\n{log}")
    fn = ctypes.CDLL(str(lib)).frtm_pyrup_bwd_f32
    tables = "const float* first" in src.read_text()
    if tables:
        fn.argtypes = _BWD_ARGTYPES + [ctypes.c_int, ctypes.c_void_p]
        extra = _BWD_TAPS_C
    else:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]
        extra = _TAPS_C
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def call(gy, gx, shape, vec=4):
        n, c, h, w = shape
        widths = (vec,) if tables else ()
        return fn(gy.data_ptr(), gx.data_ptr(), n * c, h, w, *extra, *widths, 0, stream)

    if sass_dir is not None and cuobjdump() is not None:
        sass_dir.mkdir(parents=True, exist_ok=True)
        (sass_dir / f"{tag}.sass").write_text(subprocess.run(
            [cuobjdump(), "-sass", str(lib)], capture_output=True, text=True, timeout=300).stdout)
    return call, tables, ptxas_functions(log), sass_readings(lib)


def timed(call):
    return {"ms": device_ms(call), "event_ms": event_ms(call)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of a second tree to compare with")
    ap.add_argument("--variants", action="store_true", help="also time VARIANTS")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "pyrup_bwd" / "results.json")
    ap.add_argument("--sass-dir", type=Path, help="write each tree's whole SASS there")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    resolve_device("cuda")
    lines = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}, lines)
    out_root = ROOT / "build" / "pyrup_bwd"
    trees = {"committed": kbuild.CSRC}
    if args.parent:
        trees = {"parent": args.parent / "frtm_tpu_torch" / "ops" / "kernels" / "csrc", **trees}
    if args.variants:
        trees.update({tag: variant_tree(tag, edit, out_root) for tag, edit in VARIANTS.items()})
    built, bad = {}, []
    for tag, csrc in trees.items():
        try:
            call, tables, ptxas, sass = build_tree(tag, csrc, out_root, args.sass_dir)
        except RuntimeError as e:   # the other trees are still measured
            emit({"tree": tag, "build_error": str(e)[-6000:]}, lines)
            bad.append((tag, "build"))
            continue
        built[tag] = (call, tables)
        emit({"tree": tag, "tables": tables, "ptxas": ptxas, "sass": sass}, lines)
    if "committed" not in built:
        raise SystemExit(f"failed: {bad}")
    order = list(built) + list(built)[::-1]
    g = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        n, c, h, w = shape
        gy = torch.randn(n, c, 2 * h, 2 * w, generator=g).cuda()
        want = pyr_up_bicubic_backward_plain(gy, shape)
        peak = float(want.abs().max())
        ref = torch.empty_like(want)
        if built["committed"][0](gy, ref, shape) != 0:
            raise SystemExit(f"committed kernel refused {shape}")
        line = {"shape": list(shape), "bound_ms": 4 * 5 * want.numel() / HBM_BYTES_PER_S * 1e3,
                "library": timed(lambda: torch.ops.aten.upsample_bicubic2d_backward(
                    gy, [2 * h, 2 * w], list(shape), False))}
        for tag in order:
            call, tables = built[tag]
            gx = torch.full_like(want, float("nan"))
            if call(gy, gx, shape) != 0:
                raise SystemExit(f"{tag} refused {shape}")
            torch.cuda.synchronize()
            err = float((gx - want).abs().max())
            r = line.setdefault(tag, {"max_abs_err": err, "ms": [], "event_ms": []})
            if not err <= 1e-5 * peak or (tables and not torch.equal(gx, ref)):
                bad.append((tag, shape, err, 1e-5 * peak))
            t = timed(lambda: call(gy, gx, shape))
            r["ms"].append(t["ms"])
            r["event_ms"].append(t["event_ms"])
            if tables:      # and its 8-byte loads on the same aligned gy
                r.setdefault("v2_ms", []).append(device_ms(lambda: call(gy, gx, shape, 2)))
        for vec, offset in WIDTHS:
            view = torch.empty(gy.numel() + offset, device="cuda")[offset:].view_as(gy)
            view.copy_(gy)
            gx = torch.full_like(want, float("nan"))
            call = built["committed"][0]
            if call(view, gx, shape, vec) != 0:
                raise SystemExit(f"committed kernel refused v{vec} {shape}")
            torch.cuda.synchronize()
            if not torch.equal(gx, ref):
                bad.append((f"committed v{vec} offset {offset}", shape))
            line[f"committed_v{vec}_offset{offset}"] = timed(lambda: call(view, gx, shape, vec))
        for tag in built:
            r = line[tag]
            r["bound_share"] = line["bound_ms"] / min([v for v in r["ms"] if v] or r["event_ms"])
        emit(line, lines)
        del gy, want
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(lines, indent=1))
    if bad:
        raise SystemExit(f"failed: {bad}")


if __name__ == "__main__":
    main()
