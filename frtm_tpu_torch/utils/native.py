"""The port's host library (utils/csrc/frtm_host.cpp): Telea inpainting and
the 2x2-ellipse dilation, PNG's row unfilter and sample unpacking (every
bit depth, Adam7), JPEG decoding (one frame or a batch of same-size files on
a pool of threads) and baseline JPEG encoding, and cv2.resize's nearest,
area and cubic modes on uint8 images (data/resize_host.py). The counterpart of the
JAX package's host library, without its quiet fallback: a library that does
not build raises, with the compiler's output.

At first use the source is compiled with the host compiler (`g++`) into
build/host/ at the repository root, in a file named by the hash of the
source, the flags and the JPEG backend. The compile writes a temporary name
and moves it into place with os.replace, under an exclusive lock on a file in
that directory, so that processes that reach the build at once (test workers)
wait for one compile and all load a whole library. The flags keep the
floating-point roundings of the plain Python versions: -O2 -ffp-contract=off,
no -ffast-math, no -march=native.

The JPEG decoder is chosen at build time: libjpeg where `jpeglib.h` compiles,
else nvJPEG from the CUDA toolkit that `nvcc` came with (its header
`<cuda>/include/nvjpeg.h`); with neither, the build raises an error that names
both and the paths searched. JPEG_BACKEND names what the loaded library
decodes with; PROBE records what the build found. nvJPEG's Y, Cb and Cr
planes are upsampled and converted on the host as libjpeg does it; a libjpeg
build holds that conversion against libjpeg's own output
(`decode_jpeg_planar_bytes`, for the tests).

The functions are bound with ctypes, which releases the interpreter lock for
the length of every call: a thread that inpaints or decodes does not stop
another that issues the card's work.
"""
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "frtm_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O2", "-ffp-contract=off", "-std=c++17", "-fPIC", "-shared",
             "-fvisibility=hidden", "-pthread"]

JPEG_BACKEND = None     # e.g. "libjpeg-turbo 2.1.5" or "nvjpeg 12.4", once loaded
PROBE = {}              # what the build found: headers, CUDA root, seconds
_lib = None
_lock = threading.Lock()
_ERRLEN = 256


def _compiler() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++ or c++) found: the port's host library "
                       f"({SOURCE.name}) is built from source at first use")


def _cuda_roots():
    roots = []
    if os.environ.get("CUDA_HOME"):
        roots.append(Path(os.environ["CUDA_HOME"]))
    nvcc = shutil.which("nvcc")
    if nvcc:
        roots.append(Path(nvcc).resolve().parents[1])
    roots.append(Path("/usr/local/cuda"))
    return list(dict.fromkeys(roots))


def _compiles(cxx, header) -> bool:
    probe = subprocess.run([cxx, "-std=c++17", "-fsyntax-only", "-x", "c++", "-"],
                           input=f"#include <cstdio>\n#include <{header}>\n", text=True,
                           capture_output=True)
    return probe.returncode == 0


def probe_backend(cxx=None) -> dict:
    """Which JPEG library the build can use: {"backend", "flags", "jpeglib_h",
    "nvjpeg_h", "searched"}. Raises where there is neither."""
    cxx = cxx or _compiler()
    found = {"jpeglib_h": _compiles(cxx, "jpeglib.h"), "nvjpeg_h": None}
    roots = _cuda_roots()
    for root in roots:
        if (root / "include" / "nvjpeg.h").exists():
            found["nvjpeg_h"] = str(root / "include" / "nvjpeg.h")
            break
    found["searched"] = ["jpeglib.h on the compiler's include path"] + [
        str(r / "include" / "nvjpeg.h") for r in roots]
    if found["jpeglib_h"]:
        return dict(found, backend="libjpeg", flags=["-DFRTM_HOST_LIBJPEG", "-ljpeg"])
    if found["nvjpeg_h"]:
        root = Path(found["nvjpeg_h"]).parents[1]
        libdirs = [d for d in (root / "lib64", root / "lib", root / "targets" / "x86_64-linux" / "lib")
                   if d.exists()]
        flags = ["-DFRTM_HOST_NVJPEG", f"-I{root / 'include'}"]
        for d in libdirs:
            flags += [f"-L{d}", f"-Wl,-rpath,{d}"]
        return dict(found, backend="nvjpeg", flags=flags + ["-lnvjpeg", "-lcudart"])
    raise RuntimeError(
        "the host library needs a JPEG decoder and found none: neither libjpeg "
        "(jpeglib.h does not compile) nor nvJPEG (no nvjpeg.h) is installed; searched: "
        + ", ".join(found["searched"]))


def build(directory=None) -> Path:
    """Compile the library into `directory` (default build/host) unless it is
    there already; returns its path. Safe when several processes call it at
    once."""
    directory = Path(directory) if directory is not None else BUILD_DIR
    cxx = _compiler()
    found = probe_backend(cxx)
    flags = CXX_FLAGS + found["flags"]
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join([cxx] + flags).encode())
    lib = directory / f"libfrtm_host-{h.hexdigest()[:12]}.so"
    directory.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(directory / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        compiled = not lib.exists()
        if compiled:
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *found["flags"]]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"building the host library failed:\n{' '.join(cmd)}\n"
                                       f"{res.stdout}{res.stderr}")
                os.replace(tmp, lib)
            finally:
                if tmp.exists():
                    tmp.unlink()
    PROBE.update({k: found[k] for k in ("backend", "jpeglib_h", "nvjpeg_h", "searched")},
                 library=str(lib), compiled=compiled, seconds=time.perf_counter() - t0)
    return lib


def _bind(path):
    lib = ctypes.CDLL(str(path))
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    c_int, c_long, c_char_p = ctypes.c_int, ctypes.c_long, ctypes.c_char_p
    for name, args in {
            "dilate_ellipse2_u8": [u8p, c_int, c_int, u8p],
            "inpaint_telea_u8c3": [u8p, u8p, c_int, c_int, c_int, u8p],
            "encode_jpeg": [u8p, c_int, c_int, c_int, ctypes.POINTER(u8p), ctypes.POINTER(c_long)],
            "resize_u8": [u8p, c_int, c_int, c_int, c_int, c_int, c_int, u8p],
            "jpeg_dims": [u8p, c_long, i32p, i32p, c_char_p, c_int],
            "decode_jpeg": [u8p, c_long, u8p, c_int, c_int, c_char_p, c_int],
            "batch_decode_jpeg_files": [ctypes.POINTER(c_char_p), c_int, u8p, c_int, c_int,
                                        c_int, i32p]}.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, c_int
    lib.frtm_host_jpeg_backend.argtypes, lib.frtm_host_jpeg_backend.restype = [], c_char_p
    lib.frtm_host_free.argtypes, lib.frtm_host_free.restype = [ctypes.c_void_p], None
    lib.png_samples.argtypes = [u8p, c_long, c_int, c_int, c_int, c_int, c_int, u8p]
    lib.png_samples.restype = c_long
    if hasattr(lib, "decode_jpeg_planar"):      # libjpeg builds only
        lib.decode_jpeg_planar.argtypes = [u8p, c_long, u8p, c_int, c_int, c_char_p, c_int]
        lib.decode_jpeg_planar.restype = c_int
    return lib


def library():
    """The loaded library, built at first use."""
    global _lib, JPEG_BACKEND
    with _lock:
        if _lib is None:
            _lib = _bind(build())
            JPEG_BACKEND = _lib.frtm_host_jpeg_backend().decode()
    return _lib


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def dilate_ellipse2(mask: np.ndarray) -> np.ndarray:
    """cv2.dilate with the 2x2 ellipse on a (H, W) uint8 mask."""
    mask = np.ascontiguousarray(mask, np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"dilate_ellipse2 takes a (H, W) mask, got {mask.shape}")
    out = np.empty_like(mask)
    if mask.size and library().dilate_ellipse2_u8(_u8(mask), *mask.shape, _u8(out)) != 0:
        raise RuntimeError("dilate_ellipse2_u8 failed")
    return out


def inpaint_telea(image: np.ndarray, mask: np.ndarray, radius) -> np.ndarray:
    """cv2.inpaint(image, mask, radius, INPAINT_TELEA) on (H, W, 3) uint8."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("inpaint_telea takes (H, W, 3) uint8 images")
    H, W = image.shape[:2]
    hole = np.ascontiguousarray((np.asarray(mask).reshape(H, W) != 0).astype(np.uint8))
    radius = min(max(int(round(radius)), 1), 100)
    out = np.empty_like(image)
    if image.size == 0:
        return out
    if library().inpaint_telea_u8c3(_u8(image), _u8(hole), H, W, radius, _u8(out)) != 0:
        raise RuntimeError("inpaint_telea_u8c3 failed")
    return out


_RESIZE_MODES = {"nearest": 0, "area": 1, "cubic": 2}


def resize_u8(mode: str, image: np.ndarray, size) -> np.ndarray:
    """(H, W, C) uint8 -> (dh, dw, C) uint8 by cv2's `mode` ('nearest',
    'area' or 'cubic'); data/resize_host.py checks
    the shapes and holds the plain versions."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(f"resize_u8 takes (H, W, C) uint8 images, got {image.dtype} "
                         f"{image.shape}")
    dh, dw = (int(v) for v in size)
    out = np.empty((dh, dw, image.shape[2]), np.uint8)
    if library().resize_u8(_u8(image), *image.shape, dh, dw, _RESIZE_MODES[mode], _u8(out)) != 0:
        raise ValueError(f"resize_u8 ({mode}): cannot resize {image.shape} to {(dh, dw)}")
    return out


def png_samples(raw: bytes, h: int, w: int, depth: int, channels: int,
                interlace: int) -> np.ndarray:
    """(h, w, channels) samples of a PNG's inflated image data, uint8 for
    depths 1-8 (raw values), uint16 for 16: every pass of an Adam7 image
    unfiltered, unpacked and put in its place."""
    mismatch = ValueError(f"PNG: {len(raw)} bytes of image data do not hold a {h}x{w} image "
                          f"of {channels} samples at {depth} bits (interlace {interlace})")
    if h * w * channels * depth > 8 * len(raw):     # too few bytes, whatever the layout
        raise mismatch
    out = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    if out.size == 0:
        return out
    src = np.frombuffer(raw, np.uint8)
    rc = library().png_samples(_u8(src), len(raw), h, w, depth, channels, interlace,
                               _u8(out.view(np.uint8)))
    if rc <= -2:
        raise ValueError(f"PNG: unknown filter type {raw[-2 - rc]} at byte {-2 - rc} of the "
                         "image data")
    if rc != 0:
        raise mismatch
    return out


def encode_jpeg(im: np.ndarray) -> bytes:
    """The bytes of a baseline JPEG of (H, W) greyscale or (H, W, 3) RGB
    uint8 pixels, as libjpeg writes them with PIL's defaults (quality 75);
    data/image.py's encode_jpeg_plain is the plain version."""
    im = np.ascontiguousarray(im)
    if im.dtype != np.uint8 or not (im.ndim == 2 or (im.ndim == 3 and im.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8, got {im.dtype} "
                         f"{im.shape}")
    out, n = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_long()
    c = 1 if im.ndim == 2 else 3
    if library().encode_jpeg(_u8(im), im.shape[0], im.shape[1], c, ctypes.byref(out),
                             ctypes.byref(n)) != 0:
        raise ValueError(f"encode_jpeg: cannot encode a {im.shape} image")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        library().frtm_host_free(out)


def _jpeg_dims(data: np.ndarray, name):
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if library().jpeg_dims(_u8(data), data.size, ctypes.byref(h), ctypes.byref(w),
                           err, _ERRLEN) != 0:
        raise ValueError(f"JPEG {name}: {err.value.decode(errors='replace')}")
    return h.value, w.value


def jpeg_dims(path):
    """(height, width) of a JPEG file, from its header."""
    return _jpeg_dims(np.fromfile(path, np.uint8), str(path))


def decode_jpeg_bytes(data: bytes, name="<bytes>", planar=False) -> np.ndarray:
    """A JPEG image in memory -> (H, W, 3) uint8 RGB. planar=True (libjpeg
    builds): through libjpeg's component planes and the planar conversion
    that the nvJPEG build uses."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size == 0:
        raise ValueError(f"JPEG {name}: empty")
    h, w = _jpeg_dims(buf, name)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    decode = library().decode_jpeg_planar if planar else library().decode_jpeg
    if decode(_u8(buf), buf.size, _u8(out), h, w, err, _ERRLEN) != 0:
        raise ValueError(f"JPEG {name}: {err.value.decode(errors='replace')}")
    return out


def decode_jpeg_file(path) -> np.ndarray:
    """A JPEG file -> (H, W, 3) uint8 RGB."""
    return decode_jpeg_bytes(Path(path).read_bytes(), str(path))


def batch_decode_jpeg_files(paths, h: int, w: int, n_threads: int = 0) -> np.ndarray:
    """Decode n JPEG files of size (h, w) on a pool of threads (default: one
    per core, at most 8) -> (n, h, w, 3) uint8; raises naming the first file
    that failed."""
    paths = [str(p) for p in paths]
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    if n == 0:
        return out
    n_threads = n_threads or min(8, os.cpu_count() or 1)
    status = np.zeros(n, np.int32)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failed = library().batch_decode_jpeg_files(
        names, n, _u8(out), h, w, n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if failed:
        first = paths[int(np.flatnonzero(status)[0])]
        # decode that file alone for the library's message
        decode_jpeg_file(first)
        raise ValueError(f"JPEG {first}: not a {h}x{w} image")
    return out
