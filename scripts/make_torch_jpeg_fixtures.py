#!/usr/bin/env python3
"""Write the JPEG / PNG fixture trees that the port's card checks read
(tests/data/torch_fixtures/), from seeded numpy content:

  davis/      a DAVIS-2017 layout: JPEGImages/480p/<seq>/*.jpg (9 frames,
              480x854), Annotations/480p/<seq>/*.png (every frame, two
              objects), ImageSets/2017/val.txt;
  ytvos/      a YouTube-VOS 2018 layout: valid/meta.json,
              valid/Annotations/<seq>/*.png (the start frames only) and
              valid_all_frames/JPEGImages/<seq>/*.jpg (9 frames, 720x1280);
              object 1 starts at frame 0, object 2 enters at frame 4;
  coverage/   small JPEGs in the other encodings (4:4:4, greyscale,
              progressive) and a PNG that libpng (through OpenCV) wrote with
              all five row filters;
  manifest.json  per JPEG the sha256 of PIL's decoded pixels and the PSNR of
              that decode against the source frame, per PNG the sha256 of its
              pixels and the filter types its rows use.

    python scripts/make_torch_jpeg_fixtures.py [--out tests/data/torch_fixtures]

PIL and OpenCV write the files; `source_frame` and `label_frame` are numpy
only, so that a check on a machine without PIL can rebuild the source frames
and measure its own decoder's PSNR. The content is smooth with little noise,
which keeps the committed files small.
"""
import argparse
import hashlib
import json
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "tests" / "data" / "torch_fixtures"
N_FRAMES = 9
DAVIS_SEQ, DAVIS_SIZE = "blobs", (480, 854)
YTVOS_SEQ, YTVOS_SIZE = "0a1b2c3d4e", (720, 1280)
YTVOS_ENTRY = 4            # object 2's first frame
COVERAGE_SIZE = (61, 83)
QUALITY = 85


def _objects(t, size, entry=0):
    """Per object (label, boolean mask) at frame t: an ellipse moving right and
    down, a rounded box moving left (present from frame `entry`)."""
    H, W = size
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    cy, cx = H * (0.35 + 0.015 * t), W * (0.28 + 0.02 * t)
    ell = ((yy - cy) / (0.16 * H)) ** 2 + ((xx - cx) / (0.10 * W)) ** 2 <= 1.0
    out = [(1, ell)]
    if t >= entry:
        by, bx = H * 0.62, W * (0.72 - 0.02 * (t - entry))
        box = (np.abs(yy - by) <= 0.12 * H) & (np.abs(xx - bx) <= 0.09 * W)
        out.append((2, box & ~ell))
    return out


def source_frame(t, size, seed=0, entry=0) -> np.ndarray:
    """(H, W, 3) uint8: a smooth coloured background with soft blobs and a
    little noise, the objects of `_objects` painted over it."""
    H, W = size
    rng = np.random.RandomState(seed * 1000 + t)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    u, v = xx / W, yy / H
    img = np.stack([90 + 60 * u + 20 * np.sin(5 * v + 0.3 * t),
                    110 + 40 * v + 25 * np.cos(4 * u - 0.2 * t),
                    140 - 50 * u * v + 15 * np.sin(3 * (u + v))], -1)
    for k, (label, mask) in enumerate(_objects(t, size, entry)):
        colour = np.array([[200, 60, 50], [40, 90, 210]][k], np.float64)
        shade = 1.0 + 0.15 * np.sin(12 * u + 9 * v)[..., None]
        img = np.where(mask[..., None], colour * shade, img)
    img += rng.randn(H, W, 3) * 0.5
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def label_frame(t, size, entry=0) -> np.ndarray:
    lb = np.zeros(size, np.uint8)
    for label, mask in _objects(t, size, entry):
        lb[mask] = label
    return lb


def source_of(name: str) -> np.ndarray:
    """The source frame of a manifest entry (its path under the fixture
    root), as main() encoded it; greyscale files as their grey values in
    three channels."""
    parts = Path(name).parts
    if parts[0] == "davis":
        return source_frame(int(Path(name).stem), DAVIS_SIZE, seed=1)
    if parts[0] == "ytvos":
        return source_frame(int(Path(name).stem), YTVOS_SIZE, seed=2, entry=YTVOS_ENTRY)
    src = source_frame(3, COVERAGE_SIZE, seed=3)
    if Path(name).stem == "grey":
        # ITU-R 601 luma in PIL's fixed point (Image.convert("L"))
        s = src.astype(np.int64)
        grey = (s[..., 0] * 19595 + s[..., 1] * 38470 + s[..., 2] * 7471 + 0x8000) >> 16
        return np.repeat(grey.astype(np.uint8)[..., None], 3, -1)
    return src


def psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _sha(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _png_filters(path) -> list:
    data = Path(path).read_bytes()
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, _, ctype = header[:4]
    stride = w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] + 1
    raw = zlib.decompress(b"".join(idat))
    return sorted({raw[y * stride] for y in range(h)})


def all_filters_content(h=48, w=64, seed=7) -> np.ndarray:
    """Ramps, noise, a flat band and rows built so that Average wins: libpng's
    adaptive choice uses all five filter types on it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.zeros((h, w, 3), np.int64)
    for k in range(3):
        a[..., k] = (xx * (k + 1) * 3 + yy * 2) % 256
    a[h // 4:h // 2] = rng.randint(0, 256, (h // 2 - h // 4, w, 3))
    q0, q1 = h // 2, 3 * h // 4
    a[q0, :] = np.cumsum(rng.randint(-20, 21, (w, 3)), axis=0)
    a[q0:q1, 0] = np.cumsum(rng.randint(-20, 21, (q1 - q0, 3)), axis=0)
    for y in range(q0 + 1, q1):
        for x in range(1, w):
            a[y, x] = (a[y, x - 1] % 256 + a[y - 1, x] % 256) // 2 + rng.randint(0, 2, 3)
    a[q1:] = (xx[q1:, :, None] ** 2 // 7 + yy[q1:, :, None] * xx[q1:, :, None] // 5) % 256
    a[-3:] = 17
    return (a % 256).astype(np.uint8)


def main():
    from PIL import Image
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    out = Path(ap.parse_args().out)
    if out.exists():
        shutil.rmtree(out)
    manifest = {"quality": QUALITY, "jpeg": {}, "png": {}}

    def write_jpeg(path, src, **kw):
        path.parent.mkdir(parents=True, exist_ok=True)
        im = Image.fromarray(src)
        if kw.pop("grey", False):
            im = im.convert("L")
            src = np.repeat(np.asarray(im)[..., None], 3, -1)
        im.save(path, quality=QUALITY, **kw)
        with Image.open(path) as pil:
            dec = np.asarray(pil.convert("RGB"))
        name = path.relative_to(out).as_posix()
        if not np.array_equal(source_of(name), src):
            raise SystemExit(f"source_of({name!r}) is not the frame written")
        manifest["jpeg"][name] = {
            "shape": list(dec.shape), "sha256": _sha(dec), "psnr_db": psnr(dec, src)}

    def write_label(path, lb):
        path.parent.mkdir(parents=True, exist_ok=True)
        img = Image.fromarray(lb, "P")
        img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0] + [0] * (256 * 3 - 9))
        img.save(path)

    # DAVIS: every frame annotated, both objects from frame 0
    root = out / "davis"
    for t in range(N_FRAMES):
        write_jpeg(root / "JPEGImages" / "480p" / DAVIS_SEQ / f"{t:05d}.jpg",
                   source_frame(t, DAVIS_SIZE, seed=1))
        write_label(root / "Annotations" / "480p" / DAVIS_SEQ / f"{t:05d}.png",
                    label_frame(t, DAVIS_SIZE))
    (root / "ImageSets" / "2017").mkdir(parents=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text(DAVIS_SEQ + "\n")

    # YouTube-VOS valid: annotations at each object's first frame only
    root = out / "ytvos"
    for t in range(N_FRAMES):
        write_jpeg(root / "valid_all_frames" / "JPEGImages" / YTVOS_SEQ / f"{t:05d}.jpg",
                   source_frame(t, YTVOS_SIZE, seed=2, entry=YTVOS_ENTRY))
    for t, keep in ((0, {1}), (YTVOS_ENTRY, {2})):
        lb = label_frame(t, YTVOS_SIZE, entry=YTVOS_ENTRY)
        lb[~np.isin(lb, list(keep))] = 0
        write_label(root / "valid" / "Annotations" / YTVOS_SEQ / f"{t:05d}.png", lb)
    frames = [f"{t:05d}" for t in range(N_FRAMES)]
    meta = {"videos": {YTVOS_SEQ: {"objects": {
        "1": {"category": "blob", "frames": frames},
        "2": {"category": "box", "frames": frames[YTVOS_ENTRY:]}}}}}
    (root / "valid" / "meta.json").write_text(json.dumps(meta, indent=1) + "\n")

    # coverage: the other encodings, small
    root = out / "coverage"
    src = source_frame(3, COVERAGE_SIZE, seed=3)
    write_jpeg(root / "s444.jpg", src, subsampling="4:4:4")
    write_jpeg(root / "grey.jpg", src, grey=True)
    write_jpeg(root / "progressive.jpg", src, progressive=True)
    arr = all_filters_content()
    path = root / "all_filters.png"
    # OpenCV writes through libpng; with a compression level given, libpng
    # picks the filter per row (at its default OpenCV fixes Sub)
    cv2.imwrite(str(path), arr[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, 9])
    filters = _png_filters(path)
    if filters != [0, 1, 2, 3, 4]:
        raise SystemExit(f"{path}: libpng chose filters {filters}, not all five")
    manifest["png"][path.relative_to(out).as_posix()] = {
        "shape": list(arr.shape), "sha256": _sha(arr), "filters": filters}

    (out / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"wrote {out}: {total} bytes")


if __name__ == "__main__":
    main()
