#!/usr/bin/env python3
"""Readings and times of the head conv's input-gradient kernel
(csrc/conv3x3_cout1_dx.cu, frtm_conv3x3_cout1_dx_f32) on one CUDA card: what
the compiler made of it and how long it takes at the training shape.

    python3 scripts/bench_torch_conv3x3_dx.py                 # the source as it is
    python3 scripts/bench_torch_conv3x3_dx.py --parent DIR    # and a second tree's
    python3 scripts/bench_torch_conv3x3_dx.py --variants      # and VARIANTS below

DIR is the root of another checkout of the repository, of which only
frtm_tpu_torch/ops/kernels/csrc is read (for example a `git archive` of that
directory at the parent commit, unpacked into a directory that git ignores).
Each tree's conv3x3_cout1_dx.cu is built with the port's own nvcc flags into
build/conv3x3_dx/<tree>/ (all trees at once) and bound with ctypes. Its entry
point takes the floats per store (the register walk) or not (the staged
gather before it); the script reads which from the source. With --variants,
each entry of VARIANTS is one more tree: the committed source with some text
replaced (the script fails if the text is no longer there).

Per tree it prints ptxas's registers, shared memory and spills and, where
the toolkit has cuobjdump, the SASS of every kernel function: its
instruction count, each innermost loop's length and opcodes, and
instructions per stored value (per_value: 4-byte stores hold one value, the
8-byte stores of a kernel instantiated for pairs two). Then, at the training shape
(dy (16,1,480,854), dx (16,16,480,854)) and at N = 8, each tree's gradient
is held against the plain backward (1e-5 of its peak) and bit for bit
against the committed tree's, and timed: device time per call from
torch.profiler (chip_smoke.device_ms) and CUDA events around batches of
calls (chip_smoke.event_ms), in two rounds, the second in the opposite tree
order. The committed kernel is also run at its 4-byte width on dy aligned
and 4 bytes past an aligned pointer (the same bits), run again (the same
bits), and torch.nn.grad.conv2d_input is timed once per shape, as is a
zero_() of dx's size (a pure store stream: what the card's writes reach).
Last, the committed kernel alone at two widths whose rows start 128-byte
aligned (ALIGNED_SHAPES). Prints one
JSON line per reading and writes them all to build/conv3x3_dx/results.json
(or --out).
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import HBM_BYTES_PER_S, device_ms, event_ms, ptxas_functions  # noqa: E402
from bench_torch_bf16_decoder import cuobjdump, sass_readings, variant_tree  # noqa: E402
from frtm_tpu_torch.device import resolve_device  # noqa: E402
from frtm_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from frtm_tpu_torch.ops.kernels.conv3x3_cout1 import (  # noqa: E402
    _DX_ARGTYPES, conv3x3_cout1_input_grad_plain, input_grad_plan)

SHAPES = [(16, 16, 480, 854), (8, 16, 480, 854)]
SOURCE = "conv3x3_cout1_dx"

_GROUP = "constexpr int kGroup = 4; "
_BLOCKS = "constexpr int kMinBlocks = 2; "
_ROWS = "constexpr int kRows = 3; "
_WARPS = "constexpr int kMaxWarps = 14; "
_LOAD_NEXT = "        dn = load_dy(y0 + s + 2, g);\n"

# variant -> [(source, committed text, replacement), ...]: streaming stores
# (st.global.cs), which do not keep dx's lines in L2 after the write; a
# thread owning 2 or 8 channels (8: one block an SM, the registers
# uncapped); blocks of up to 7 warps (half a training row, four blocks an SM
# at the same registers); stripes of 2 to 60 rows (30 is what a plan of
# whole waves took at the training shape); dy rows prefetched into L2 4
# rows past the one loaded
VARIANTS = {
    "stcs": [(SOURCE, "if (in_a) *reinterpret_cast<float2*>(p) = make_float2(a, b);",
              "if (in_a) __stcs(reinterpret_cast<float2*>(p), make_float2(a, b));"),
             (SOURCE, "if (in_a) p[0] = a;", "if (in_a) __stcs(p, a);"),
             (SOURCE, "if (in_b) p[1] = b;", "if (in_b) __stcs(p + 1, b);")],
    "group2": [(SOURCE, _GROUP, _GROUP.replace("4", "2"))],
    "group8": [(SOURCE, _GROUP, _GROUP.replace("4", "8")),
               (SOURCE, _BLOCKS, _BLOCKS.replace("2", "1"))],
    "warps7": [(SOURCE, _WARPS, _WARPS.replace("14", "7")),
               (SOURCE, _BLOCKS, _BLOCKS.replace("2", "4"))],
    **{f"rows{r}": [(SOURCE, _ROWS, _ROWS.replace("3", str(r)))]
       for r in (2, 4, 5, 6, 8, 12, 16, 30, 60)},
    "prefetch4": [(SOURCE, _LOAD_NEXT,
                   "        if (in_a && y0 + s + 6 < H)\n"
                   "          asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(g + 4 * W));\n"
                   + _LOAD_NEXT)],
}
# widths whose rows start 128-byte aligned (3328 and 3456 bytes), beside the
# training width's 3416-byte rows: what partial lines at warp and row edges cost
ALIGNED_SHAPES = [(16, 16, 480, 832), (16, 16, 480, 864)]


def emit(obj, lines):
    lines.append(obj)
    print(json.dumps(obj), flush=True)


def per_value(sass, text):
    """Instructions per stored value in each kernel function of one
    library's SASS readings (`text` its cuobjdump -sass): each innermost
    loop's length over the values its stores write, and, for a function
    with no loop (the walk, unrolled over its stripe), the whole function's
    instructions over the values of all its stores. A store writes two
    values in a function instantiated for pairs (`<2>`), else one."""
    if sass is None:
        return None
    stores = {}     # function -> STG instructions, in cuobjdump's order
    for part in text.split("Function : ")[1:]:
        stores[part.split()[0]] = len(re.findall(r"\bSTG\.", part))
    for (name, f), n_stg in zip(sass.items(), stores.values()):
        values = 2 if "<2>" in name else 1
        for loop in f["loops"]:
            n = loop["opcodes"].get("STG", 0)
            loop["per_stored_value"] = loop["length"] / (values * n) if n else None
        f["stores"] = n_stg
        f["per_stored_value"] = f["instructions"] / (values * n_stg) if n_stg else None
    return sass


def build_trees(trees, out_root, sass_dir=None):
    """{tag: (call(gy, w, dx, vec) -> rc, walk, ptxas, sass)} of every tree
    that built, and {tag: log} of those that did not; nvcc runs for all the
    trees at once. The whole SASS goes to sass_dir/<tag>.sass where given."""
    procs = {}
    for tag, csrc in trees.items():
        out = out_root / tag
        out.mkdir(parents=True, exist_ok=True)
        lib = out / f"lib{SOURCE}.so"
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
               str(csrc / f"{SOURCE}.cu")]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib, csrc)
    built, failed = {}, {}
    stream = torch.cuda.current_stream().cuda_stream
    for tag, (p, lib_path, csrc) in procs.items():
        log, _ = p.communicate(timeout=600)
        if p.returncode:
            failed[tag] = log
            continue
        lib = ctypes.CDLL(str(lib_path))
        walk = "int vec" in (csrc / f"{SOURCE}.cu").read_text()
        fn = lib.frtm_conv3x3_cout1_dx_f32
        fn.argtypes = (_DX_ARGTYPES if walk else _DX_ARGTYPES[:-1]) + [ctypes.c_int,
                                                                       ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(gy, w, dx, vec=2, fn=fn, walk=walk):
            n, c, h, wd = dx.shape
            widths = (vec,) if walk else ()
            return fn(gy.data_ptr(), w.data_ptr(), dx.data_ptr(), n, c, h, wd, *widths, 0,
                      stream)

        if walk:        # the stripe rows it plans, per shape
            plan = lib.frtm_conv3x3_cout1_dx_plan
            plan.argtypes = [ctypes.c_int] * 5
            plan.restype = ctypes.c_int
            call.rows = lambda shape, plan=plan: plan(*shape, 0)

        text = "" if cuobjdump() is None else subprocess.run(
            [cuobjdump(), "-sass", str(lib_path)], capture_output=True, text=True,
            timeout=300).stdout
        if sass_dir is not None and text:
            sass_dir.mkdir(parents=True, exist_ok=True)
            (sass_dir / f"{tag}.sass").write_text(text)
        built[tag] = (call, walk, ptxas_functions(log),
                      per_value(sass_readings(lib_path), text))
    return built, failed


def timed(call):
    return {"ms": device_ms(call), "event_ms": event_ms(call)}


def offset_copy(t, offset):
    """t's values in a view `offset` floats past an aligned pointer."""
    view = torch.empty(t.numel() + offset, device="cuda")[offset:].view_as(t)
    view.copy_(t)
    return view


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of a second tree to compare with")
    ap.add_argument("--variants", action="store_true", help="also time VARIANTS")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "conv3x3_dx" / "results.json")
    ap.add_argument("--sass-dir", type=Path, help="write each tree's whole SASS there")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    resolve_device("cuda")
    lines = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}, lines)
    out_root = ROOT / "build" / "conv3x3_dx"
    trees = {"committed": kbuild.CSRC}
    if args.parent:
        trees = {"parent": args.parent / "frtm_tpu_torch" / "ops" / "kernels" / "csrc", **trees}
    if args.variants:
        trees.update({tag: variant_tree(tag, edits, out_root) for tag, edits in VARIANTS.items()})
    built, failed = build_trees(trees, out_root, args.sass_dir)
    bad = [(tag, "build") for tag in failed]
    for tag, log in failed.items():     # the other trees are still measured
        emit({"tree": tag, "build_error": log[-6000:]}, lines)
    for tag, (_, walk, ptxas, sass) in built.items():
        emit({"tree": tag, "walk": walk, "ptxas": ptxas, "sass": sass}, lines)
    if "committed" not in built:
        raise SystemExit(f"failed: {bad}")
    order = list(built) + list(built)[::-1]
    g = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        n, c, h, w = shape
        wt = (torch.rand(1, c, 3, 3, generator=g) * 0.2 - 0.1).cuda()
        gy = (torch.randn(n, 1, h, w, generator=g) * 1e-3).cuda()
        want = conv3x3_cout1_input_grad_plain(gy, wt, shape)
        peak = float(want.abs().max())
        del want
        ref = torch.empty(shape, device="cuda")
        call = built["committed"][0]
        if call(gy, wt, ref) != 0:
            raise SystemExit(f"committed kernel refused {shape}")
        torch.cuda.synchronize()
        err = float((ref - conv3x3_cout1_input_grad_plain(gy, wt, shape)).abs().max())
        if not err <= 1e-5 * peak:
            bad.append(("committed", shape, err, 1e-5 * peak))
        line = {"shape": list(shape), "max_abs_err": err, "peak": peak,
                "bound_ms": 4 * (gy.numel() + ref.numel() + wt.numel()) / HBM_BYTES_PER_S * 1e3,
                "rows": input_grad_plan(n, c, h, w),
                "warps": input_grad_plan(n, c, h, w, "warps"),
                "library": timed(lambda: torch.nn.grad.conv2d_input(shape, wt, gy, padding=1))}
        out = torch.empty_like(ref)
        # a store stream of dx's bytes with nothing else: PyTorch's fill
        line["zero_"] = timed(out.zero_)
        line["zero_"]["bound_share"] = 4 * out.numel() / HBM_BYTES_PER_S * 1e3 / min(
            [v for v in line["zero_"].values() if v])
        for tag in order:
            call = built[tag][0]
            out.fill_(float("nan"))
            if call(gy, wt, out) != 0:
                raise SystemExit(f"{tag} refused {shape}")
            torch.cuda.synchronize()
            r = line.setdefault(tag, {"equal_to_committed": torch.equal(out, ref),
                                      "rows": getattr(call, "rows", lambda s: None)(shape),
                                      "ms": [], "event_ms": []})
            if not r["equal_to_committed"]:
                bad.append((tag, shape, "bits differ from the committed kernel's"))
            t = timed(lambda: call(gy, wt, out))
            r["ms"].append(t["ms"])
            r["event_ms"].append(t["event_ms"])
        call = built["committed"][0]
        out.fill_(float("nan"))
        if call(gy, wt, out) != 0:
            raise SystemExit(f"committed kernel refused a re-run of {shape}")
        torch.cuda.synchronize()
        line["committed"]["rerun_equal"] = torch.equal(out, ref)
        if not line["committed"]["rerun_equal"]:
            bad.append(("committed re-run", shape))
        for offset in (0, 1):       # 4-byte loads and stores, dy aligned and 4 bytes past
            gv = offset_copy(gy, offset)
            out.fill_(float("nan"))
            if call(gv, wt, out, 1) != 0:
                raise SystemExit(f"committed kernel refused v1 offset {offset} {shape}")
            torch.cuda.synchronize()
            equal = torch.equal(out, ref)
            if not equal:
                bad.append((f"committed v1 offset {offset}", shape))
            line[f"committed_v1_offset{offset}"] = {"equal_to_v2": equal,
                                                     **timed(lambda: call(gv, wt, out, 1))}
            del gv
        for tag in built:
            r = line[tag]
            best = min([v for v in r["ms"] if v] or r["event_ms"])
            r["bound_share"] = line["bound_ms"] / best
            r["event_bound_share"] = line["bound_ms"] / min(r["event_ms"])
            r["library_ratio"] = best / (line["library"]["ms"] or line["library"]["event_ms"])
        emit(line, lines)
        del gy, ref, out
        torch.cuda.empty_cache()
    call = built["committed"][0]
    for shape in ALIGNED_SHAPES:
        n, c, h, w = shape
        wt = (torch.rand(1, c, 3, 3, generator=g) * 0.2 - 0.1).cuda()
        gy = (torch.randn(n, 1, h, w, generator=g) * 1e-3).cuda()
        out = torch.empty(shape, device="cuda")
        if call(gy, wt, out) != 0:
            raise SystemExit(f"committed kernel refused {shape}")
        t = timed(lambda: call(gy, wt, out))
        bound = 4 * (gy.numel() + out.numel() + wt.numel()) / HBM_BYTES_PER_S * 1e3
        emit({"aligned_shape": list(shape), "rows": call.rows(shape), **t,
              "bound_ms": bound, "bound_share": bound / min(v for v in t.values() if v)},
             lines)
        del gy, out
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(lines, indent=1))
    if bad:
        raise SystemExit(f"failed: {bad}")


if __name__ == "__main__":
    main()
