"""Build and bind the port's CUDA kernels.

Each source in csrc/ has a plain C interface and no PyTorch headers, so it
compiles with `nvcc` alone in seconds. At first use every missing library is
compiled for sm_90a — one `nvcc` per source, all started together — into
build/torch_ext/ at the repository root, named by the hash of its source and
flags, and loaded with ctypes. Nothing prebuilt is committed. A failed build
raises; there is no fallback.

LAUNCHES counts, per kernel, the launches its wrapper made; a run reads it to
show which kernels the main path went through. VARIANTS splits each kernel's
count by the instance a launch took: the element type of kernels 1 and 2, the
staged or direct variant of the warp (one map, or S maps in one launch:
"staged_batched", "direct_batched"), the load width of `pyrup_bwd` (16,
8 or 4 bytes: "v4", "v2", "v1") and of `conv3x3_cout1_dw` (8 or 4 bytes:
"v2", "v1"), and the store width of `conv3x3_cout1_dx` (8 or 4 bytes: "v2",
"v1"). The backward kernels of 1 and 2 (`pyrup_bwd`,
`conv3x3_cout1_dx`, `conv3x3_cout1_dw`) have a float32 instance only.

SOURCES names the libraries, one per source. A kernel's bfloat16 instance
may have a source of its own (kernels 1 and 2: `pyrup_bf16`,
`conv3x3_cout1_bf16`, each its own design for 2-byte elements); its
launches count under the kernel's name all the same.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("pyrup", "conv3x3_cout1", "warp_affine", "pyrup_bwd", "conv3x3_cout1_dx",
           "conv3x3_cout1_dw")
SOURCES = KERNELS + ("pyrup_bf16", "conv3x3_cout1_bf16")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

LAUNCHES = {name: 0 for name in KERNELS}
VARIANTS = {"pyrup": {"f32": 0, "bf16": 0},
            "conv3x3_cout1": {"f32": 0, "bf16": 0},
            "warp_affine": {"staged": 0, "direct": 0, "staged_batched": 0,
                            "direct_batched": 0},
            "pyrup_bwd": {"v4": 0, "v2": 0, "v1": 0}, "conv3x3_cout1_dx": {"v2": 0, "v1": 0},
            "conv3x3_cout1_dw": {"v2": 0, "v1": 0}}
# the element types kernels 1 and 2 are instantiated for, by instance name
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BUILD_LOG = {}      # source name -> nvcc output (ptxas register/smem report),
                    # kept beside each library and read back where it was built before

_libs = {}
_lock = threading.Lock()


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in VARIANTS.values():
        for variant in counts:
            counts[variant] = 0


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "torch_ext"


def _nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    for c in candidates:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "source at first use")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1()
    for part in (src.read_bytes(), (CSRC / "common.cuh").read_bytes(),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compile (in parallel) and load every named kernel not loaded yet;
    returns the seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return 0.0
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        try:
            for n in todo:
                lib = _lib_path(n)
                if lib.exists():
                    log = lib.with_suffix(".log")
                    if log.exists():
                        BUILD_LOG[n] = log.read_text()
                    continue
                tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
                procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True),
                            tmp, lib)
            for n, (p, tmp, lib) in procs.items():
                log, _ = p.communicate()
                BUILD_LOG[n] = log
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
                lib.with_suffix(".log").write_text(log)
                os.replace(tmp, lib)
        finally:
            for p, tmp, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                if tmp.exists():
                    tmp.unlink()
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_lib_path(n)))
    return time.perf_counter() - t0


def library(name: str):
    """The loaded ctypes library of one source (built at first use)."""
    if name not in _libs:
        build((name,))
    return _libs[name]


def instance_of(t: torch.Tensor, what: str) -> str:
    """The instance name ("f32" or "bf16") for a tensor's element type."""
    for name, dtype in DTYPES.items():
        if t.dtype == dtype:
            return name
    raise TypeError(f"{what}: expected float32 or bfloat16, got {t.dtype}")


def check_cuda_tensor(t: torch.Tensor, what: str, ndim: int, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def launch(name: str, fn_name: str, argtypes, *args, device: torch.device, variant=None,
           source=None):
    """Call one C entry point of kernel `name` (in the library of `source`,
    by default the kernel's own) on the current stream of `device`; raise on
    a refused launch, count it (and its variant) otherwise."""
    lib = library(source or name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.frtm_error_string.argtypes = [ctypes.c_int]
        lib.frtm_error_string.restype = ctypes.c_char_p
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, index, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.frtm_error_string(rc).decode()}")
    LAUNCHES[name] += 1
    if variant is not None:
        VARIANTS[name][variant] += 1
