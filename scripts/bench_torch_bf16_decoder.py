#!/usr/bin/env python3
"""Readings and times of the decoder's two kernels, pyrup (kernel 1) and the
head conv (kernel 2), in float32 and bfloat16, on one CUDA card: what the
compiler made of each instance and how long it takes at the shapes the
decoder gives it.

    python3 scripts/bench_torch_bf16_decoder.py                 # the sources as they are
    python3 scripts/bench_torch_bf16_decoder.py --parent DIR    # and a second tree's
    python3 scripts/bench_torch_bf16_decoder.py --variants      # and design variants

DIR is the root of another checkout of the repository, of which only
frtm_tpu_torch/ops/kernels/csrc is read (for example a `git archive` of
that directory at the parent commit, unpacked into a directory that git
ignores). Each tree's csrc/ sources of the two kernels (pyrup.cu,
conv3x3_cout1.cu, and pyrup_bf16.cu, conv3x3_cout1_bf16.cu where they
exist) are built with the port's own nvcc flags into
build/bf16_decoder/<tree>/ and bound with ctypes by their exported names,
frtm_pyrup_{f32,bf16} and frtm_conv3x3_cout1_{f32,bf16}.

With --variants, each entry of VARIANTS below is one more tree: the
committed csrc/ with a few lines of the bfloat16 sources replaced (the
script fails if a line is no longer there); only its bfloat16 instances are
timed.

Per tree it prints ptxas's registers, shared memory and spills of every
kernel and, where the toolkit has cuobjdump, the SASS of every kernel
function: its instruction count and, for each innermost loop (a branch back
to an earlier instruction), the loop's length and its instructions by
opcode.
Then, for every shape and instance, each tree's output is held against the
plain version (pyrup bit for bit, the head conv within one bfloat16 ulp at
the output's peak, 5e-5 in float32) and timed: device time per call from
torch.profiler (chip_smoke.device_ms) and CUDA events around batches of
calls (chip_smoke.event_ms), in two rounds, the second in the opposite tree
order (parent, committed, variants, then back). Shapes: the DAVIS decoder's (480x854: pyrup (N,32,120,214)
and (N,16,240,428), the conv (N,16,480,854)) at N = 1, 2 and 16, and
YouTube-VOS's (720x1280) at N = 1 and 2. Prints one JSON line per reading
and writes them all to build/bf16_decoder/results.json (or --out).
"""
import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (HBM_BYTES_PER_S, demangle, device_ms, event_ms,  # noqa: E402
                        ptxas_functions)
from frtm_tpu_torch.device import resolve_device  # noqa: E402
from frtm_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from frtm_tpu_torch.ops.kernels.conv3x3_cout1 import (_ARGTYPES as CONV_ARGS,  # noqa: E402
                                                      conv3x3_cout1_plain)
from frtm_tpu_torch.ops.kernels.pyrup import (_ARGTYPES as PYRUP_ARGS, _TAPS_C,  # noqa: E402
                                              pyr_up_bicubic_plain)

SOURCES = ("pyrup", "pyrup_bf16", "conv3x3_cout1", "conv3x3_cout1_bf16")
SYMBOLS = {f"frtm_{k}_{i}": k for k in ("pyrup", "conv3x3_cout1") for i in ("f32", "bf16")}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

PYRUP_SHAPES = [(n, c, h, w) for n in (1, 2, 16) for c, h, w in ((32, 120, 214), (16, 240, 428))] \
    + [(n, c, h, w) for n in (1, 2) for c, h, w in ((32, 180, 320), (16, 360, 640))]
CONV_SHAPES = [(n, 16, 480, 854) for n in (1, 2, 16)] + [(n, 16, 720, 1280) for n in (1, 2)]

_CHUNK = "for (ch.pairs = 8;; ch.pairs /= 2) {"
_CHANS = "constexpr int kChans = 4;"
_STAGES = "constexpr int kStages = 2;"


def _conv(chans, stages):
    """The head conv with `chans` channels a stage and `stages` stages."""
    return [("conv3x3_cout1_bf16", _CHANS, _CHANS.replace("4", str(chans))),
            ("conv3x3_cout1_bf16", _STAGES, _STAGES.replace("2", str(stages)))]


# variant -> [(source, committed text, replacement)]
VARIANTS = {
    # the head conv's staging: channels a stage x stages in flight
    "c2s2": _conv(2, 2), "c4s3": _conv(4, 3), "c2s3": _conv(2, 3), "c2s4": _conv(2, 4),
    "c1s4": _conv(1, 4),
    # pyrup's chunks: at most 4 or 16 row pairs
    "pairs4": [("pyrup_bf16", _CHUNK, _CHUNK.replace("= 8;", "= 4;"))],
    "pairs16": [("pyrup_bf16", _CHUNK, _CHUNK.replace("= 8;", "= 16;"))],
}


def emit(obj, lines):
    lines.append(obj)
    print(json.dumps(obj), flush=True)


def cuobjdump():
    for c in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if c and Path(c).exists():
            return c
    return None


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)(\S*)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# a branch's target: a label (`(.L_x_3)`) or an address (0x1a30)
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def sass_readings(lib):
    """{function: {"instructions": n, "loops": [{"length", "opcodes"}, ...]}}
    for the innermost loops of every kernel function in the library."""
    tool = cuobjdump()
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = {"instrs": [], "labels": {}}
            continue
        if name is None:
            continue
        f = funcs[name]
        m = _LABEL.match(ln)
        if m:
            f["labels"][m.group(1)] = len(f["instrs"])
            continue
        m = _INSTR.search(ln)
        if m:
            f["labels"][int(m.group(1), 16)] = len(f["instrs"])
            t = _TARGET.search(ln[m.end():]) if "BRA" in m.group(2) else None
            tgt = None if t is None else t.group(1) or int(t.group(2), 16)
            f["instrs"].append((m.group(2), tgt))
    names = dict(zip(funcs, demangle(list(funcs))))
    out = {}
    for mangled, f in funcs.items():
        # backward branches over 3 or more instructions (not the trap loop
        # after EXIT)
        loops = [(f["labels"][tgt], i) for i, (_, tgt) in enumerate(f["instrs"])
                 if tgt in f["labels"] and f["labels"][tgt] <= i - 2]
        inner = [(a, b) for a, b in loops
                 if not any((c, d) != (a, b) and a <= c and d <= b for c, d in loops)]
        out[names[mangled]] = {
            "instructions": len(f["instrs"]),
            "loops": [{"length": b - a + 1,
                       "opcodes": dict(Counter(op for op, _ in f["instrs"][a:b + 1])
                                       .most_common())}
                      for a, b in sorted(set(inner))]}
    return out


def variant_tree(tag, edits, out_root):
    """The committed csrc/ with one variant's edits, in out_root/src_<tag>."""
    out = out_root / f"src_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(kbuild.CSRC, out)
    for name, old, new in edits:
        path = out / f"{name}.cu"
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {tag}: no longer matches {name}.cu: {old!r}")
        path.write_text(text.replace(old, new))
    return out


def build_tree(tag, csrc, out_root):
    """Compile the tree's kernel sources in parallel; (symbol -> function,
    ptxas lines, SASS readings)."""
    out = out_root / tag
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = csrc / f"{name}.cu"
        if src.exists():
            cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(csrc),
                   "-o", str(out / f"lib{name}.so"), str(src)]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
    fns, ptxas, sass = {}, {}, {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {tag}/{name}.cu:\n{log}")
        ptxas[name] = ptxas_functions(log)
        lib = out / f"lib{name}.so"
        sass[name] = sass_readings(lib)
        cdll = ctypes.CDLL(str(lib))
        for sym, kernel in SYMBOLS.items():
            if hasattr(cdll, sym) and sym not in fns:
                fn = getattr(cdll, sym)
                fn.argtypes = (PYRUP_ARGS if kernel == "pyrup" else CONV_ARGS) + [
                    ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                fns[sym] = fn
    missing = set(SYMBOLS) - set(fns)
    if missing:
        raise RuntimeError(f"{tag}: no {sorted(missing)} in its sources")
    return fns, ptxas, sass


def cases(g):
    """(kernel, instance, shape, C arguments, output, plain output, tolerance,
    bytes moved, the inputs kept alive)."""
    out = []
    for shape in PYRUP_SHAPES:
        x32 = torch.randn(shape, generator=g).cuda()
        for inst, dt in DTYPES.items():
            x = x32.to(dt)
            n, c, h, w = shape
            y = torch.empty((n, c, 2 * h, 2 * w), dtype=dt, device="cuda")
            args = (x.data_ptr(), y.data_ptr(), n * c, h, w, *_TAPS_C)
            out.append(("pyrup", inst, shape, args, y, pyr_up_bicubic_plain(x), 0.0,
                        x.element_size() * 5 * x.numel(), x))
    wt = torch.rand(1, 16, 3, 3, generator=g) * 0.2 - 0.1
    bt = torch.rand(1, generator=g) * 0.2 - 0.1
    for shape in CONV_SHAPES:
        x32 = torch.relu(torch.randn(shape, generator=g)).cuda()
        for inst, dt in DTYPES.items():
            x, w, b = x32.to(dt), wt.cuda().to(dt), bt.cuda().to(dt)
            n, c, h, wd = shape
            y = torch.empty((n, 1, h, wd), dtype=dt, device="cuda")
            args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, c, h, wd)
            want = conv3x3_cout1_plain(x, w, b)
            peak = float(want.float().abs().max())
            tol = 2.0 ** (math.floor(math.log2(peak)) - 7) if inst == "bf16" else 5e-5
            out.append(("conv3x3_cout1", inst, shape, args, y, want, tol,
                        x.element_size() * (x.numel() + y.numel() + w.numel() + 1), (x, w, b)))
        del x32
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of a second tree to compare with")
    ap.add_argument("--variants", action="store_true", help="also time VARIANTS")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "bf16_decoder" / "results.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    resolve_device("cuda")
    lines = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}, lines)
    trees = {"committed": kbuild.CSRC}
    if args.parent:
        trees = {"parent": args.parent / "frtm_tpu_torch" / "ops" / "kernels" / "csrc", **trees}
    out_root = ROOT / "build" / "bf16_decoder"
    if args.variants:
        trees.update({tag: variant_tree(tag, edits, out_root) for tag, edits in VARIANTS.items()})
    built, bad = {}, []
    for tag, csrc in trees.items():
        try:
            fns, ptxas, sass = build_tree(tag, csrc, out_root)
        except RuntimeError as e:   # the other trees are still measured
            emit({"tree": tag, "build_error": str(e)[-6000:]}, lines)
            bad.append((tag, "build"))
            continue
        built[tag] = fns
        emit({"tree": tag, "ptxas": ptxas, "sass": sass}, lines)
    order = list(built) + list(built)[::-1]
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)
    for kernel, inst, shape, cargs, y, want, tol, nbytes, _ in cases(g):
        line = {"kernel": kernel, "instance": inst, "shape": list(shape),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        for tag in order:
            if inst == "f32" and tag in VARIANTS:
                continue
            fn = built[tag][f"frtm_{kernel}_{inst}"]
            call = lambda fn=fn: fn(*cargs, 0, stream)  # noqa: E731
            y.fill_(float("nan"))
            if call() != 0:
                raise SystemExit(f"{tag} refused {kernel} {inst} {shape}")
            torch.cuda.synchronize()
            err = float((y.float() - want.float()).abs().max())
            r = line.setdefault(tag, {"max_abs_err": err, "ms": [], "event_ms": []})
            if not err <= tol:
                bad.append((tag, kernel, inst, shape, err, tol))
            if inst == "bf16" and kernel == "conv3x3_cout1":
                r["values_equal_share"] = float((y == want).float().mean())
            r["ms"].append(device_ms(call))
            r["event_ms"].append(event_ms(call))
        for tag in built:
            if tag not in line:
                continue
            r = line[tag]
            r["bound_share"] = line["bound_ms"] / min([v for v in r["ms"] if v] or r["event_ms"])
        emit(line, lines)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(lines, indent=1))
    if bad:
        raise SystemExit(f"failed: {bad}")


if __name__ == "__main__":
    main()
