#!/usr/bin/env python3
"""Times design variants of the port's staged warp kernel
(frtm_tpu_torch/ops/kernels/csrc/warp_affine.cu) against the kernel as
committed, on one CUDA card, on the warps the augmenter runs.

    python3 scripts/bench_torch_warp_variants.py     # one CUDA card and nvcc

Each variant is the committed source with a few lines replaced (listed in
VARIANTS below; the script fails if a line is no longer there), built with
the port's own nvcc flags into build/warp_variants/ and bound with ctypes:

  committed  the kernel as it is: 8x4 output patches per warp, channels
             sampled one after another, 8 or 4 warps a block by the tile
             count
  rows       a warp takes 32 outputs of one row, not an 8x4 patch
  xpairs     a thread takes x-adjacent output pairs (16x4 per warp) and
             stores them with one 8-byte store where the row allows
  warps8     8 warps a block (2 outputs each) for every output size
  warps4     4 warps a block (4 outputs each) for every output size
  groups4    up to 4 channels sampled together from each output's taps
  groups3    up to 3 channels sampled together

Rows: chip_smoke.py's four warps (the rotated background, the foreground
RGBA and label boxes, the worst footprint) and the eval augmenter's
background (scale 1.2 about the frame centre, no rotation). Every variant's
output is held against the plain version bit for bit. Times are the
profiler's device time per call (chip_smoke.device_ms), over two rounds in
opposite variant order. Prints one JSON line per round and row, and writes
them all to build/warp_variants/results.json.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms  # noqa: E402
from frtm_tpu_torch.device import resolve_device  # noqa: E402
from frtm_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from frtm_tpu_torch.ops.kernels.warp_affine import _ARGTYPES, plan_warp  # noqa: E402
from frtm_tpu_torch.ops.warp import MODES, inverse_coefficients, warp_affine_plain  # noqa: E402

_MAP_PATCH = """    ox[i] = tx0 + 8 * (p & 3) + (lane & 7);
    oy[i] = ty0 + 4 * (p >> 2) + (lane >> 3);"""
_OUTPUT_INDEX = "const int p = (threadIdx.x >> 5) + kWarps * i, lane = threadIdx.x & 31;"
_STORE = """  for (int c = 0; c < C; ++c) {
    const float* s = stage + c * stage_floats;
    float* o = out + c * oplane;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float v = sample_staged<MODE>(s + off[i], SW, w[i]);
      if (valid[i]) o[static_cast<size_t>(oy[i]) * OW + ox[i]] = v;
    }
  }"""
_STORE_PAIRS = """  for (int c = 0; c < C; ++c) {
    const float* s = stage + c * stage_floats;
    float* o = out + c * oplane;
#pragma unroll
    for (int i = 0; i < kPerThread; i += 2) {
      const float v0 = sample_staged<MODE>(s + off[i], SW, w[i]);
      const float v1 = sample_staged<MODE>(s + off[i + 1], SW, w[i + 1]);
      float* p = o + static_cast<size_t>(oy[i]) * OW + ox[i];
      if (valid[i + 1] && (OW & 1) == 0) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        if (valid[i]) p[0] = v0;
        if (valid[i + 1]) p[1] = v1;
      }
    }
  }"""
_STORE_GROUPS = """  constexpr int kC = 4;
  for (int c = 0; c < C; c += kC) {
    const int nc = min(kC, C - c);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float* s = stage + c * stage_floats + off[i];
      float v[kC];
#pragma unroll
      for (int k = 0; k < kC; ++k)
        if (k < nc) v[k] = sample_staged<MODE>(s + k * stage_floats, SW, w[i]);
      float* o = out + c * oplane + static_cast<size_t>(oy[i]) * OW + ox[i];
#pragma unroll
      for (int k = 0; k < kC; ++k)
        if (k < nc && valid[i]) o[k * oplane] = v[k];
    }
  }"""
_WIDE = "const bool wide = tiles >= 4LL * sms;"

# variant -> [(committed text, replacement)]
VARIANTS = {
    "committed": [],
    "rows": [(_MAP_PATCH, "    ox[i] = tx0 + lane;\n    oy[i] = ty0 + p;")],
    "xpairs": [
        (_OUTPUT_INDEX,
         "const int p = (threadIdx.x >> 5) + kWarps * (i >> 1), lane = threadIdx.x & 31;"),
        (_MAP_PATCH, "    ox[i] = tx0 + 16 * (p & 1) + 2 * (lane & 7) + (i & 1);\n"
                     "    oy[i] = ty0 + 4 * (p >> 1) + (lane >> 3);"),
        (_STORE, _STORE_PAIRS)],
    "warps8": [(_WIDE, "const bool wide = false;")],
    "warps4": [(_WIDE, "const bool wide = true;")],
    "groups4": [(_STORE, _STORE_GROUPS)],
    "groups3": [(_STORE, _STORE_GROUPS.replace("kC = 4", "kC = 3"))],
}


def variant_source(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant edit no longer matches the committed source: {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(out_dir):
    """Compile every variant in parallel; name -> (ctypes library, ptxas lines)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    base = (kbuild.CSRC / "warp_affine.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(base, edits))
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-I", str(kbuild.CSRC),
               "-o", str(out_dir / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).frtm_warp_affine_maps_f32
        fn.argtypes = _ARGTYPES + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (fn, [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                           if "registers" in ln or ("spill" in ln and " 0 bytes spill" not in ln)])
    return libs


def rows():
    """(name, source, forward map, output size, mode) of the timed warps."""
    g = torch.Generator().manual_seed(0)
    T = np.array([[1.2 * np.cos(0.3), 1.2 * np.sin(0.3), -60.0],
                  [-1.2 * np.sin(0.3), 1.2 * np.cos(0.3), 90.0], [0, 0, 1]])
    Ts = np.array([[1, 0, -300.0], [0, 1, -150.0], [0, 0, 1]]) @ T
    a = np.deg2rad(45)
    Tw = (np.array([[1, 0, 120.0], [0, 1, 100.0], [0, 0, 1]])
          @ np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]])
          @ np.diag([0.5, 0.5, 1.0]) @ np.array([[1, 0, -427.0], [0, 1, -240.0], [0, 0, 1]]))
    Te = np.array([[1.2, 0, 427.0 - 1.2 * 427.0], [0, 1.2, 240.0 - 1.2 * 240.0], [0, 0, 1]])
    img = (torch.rand(3, 480, 854, generator=g) * 255).cuda()
    rgba = (torch.rand(4, 480, 854, generator=g) * 255).cuda()
    lbl = (torch.rand(1, 480, 854, generator=g) > 0.5).float().cuda()
    return [("background", img, T, (480, 854), "bicubic"),
            ("background_eval", img, Te, (480, 854), "bicubic"),
            ("foreground", rgba, Ts, (200, 240), "bicubic"),
            ("label", lbl, Ts, (200, 240), "nearest"),
            ("foreground_worst", rgba, Tw, (200, 240), "bicubic")]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build_variants(ROOT / "build" / "warp_variants")
    lines = [{"card": smi, "ptxas": {n: log for n, (_, log) in libs.items()}}]
    print(json.dumps(lines[0]), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for name, src, M, size, mode in rows():
        hinv = inverse_coefficients(M)
        plan = plan_warp(hinv, size, mode, src.shape[0])
        assert plan.variant == "staged", name
        out = torch.empty((src.shape[0],) + size, device="cuda")
        args = (src.data_ptr(), out.data_ptr(), src.shape[0], 0, src.shape[1], src.shape[2],
                size[0], size[1], (ctypes.c_float * 9)(*hinv.tolist()), 1, MODES.index(mode),
                plan.box[1], plan.box[0], 0, stream)
        cases.append((name, out, args, warp_affine_plain(src, hinv, size, mode)))
    order = list(libs)
    for rnd in range(2):
        for name, out, args, want in cases:
            line = {"round": rnd, "row": name}
            for v in (order if rnd == 0 else order[::-1]):
                fn = libs[v][0]
                out.fill_(float("nan"))
                if fn(*args) != 0:
                    raise SystemExit(f"{v} refused {name}")
                torch.cuda.synchronize()
                line[v] = {"ms": device_ms(lambda: fn(*args)), "exact": torch.equal(out, want)}
            lines.append(line)
            print(json.dumps(line), flush=True)
    (ROOT / "build" / "warp_variants" / "results.json").write_text(json.dumps(lines, indent=1))
    bad = [(ln["row"], v) for ln in lines[1:] for v in VARIANTS if not ln[v]["exact"]]
    if bad:
        raise SystemExit(f"variants not bit-exact: {bad}")


if __name__ == "__main__":
    main()
