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
  imwrite/    JPEGs that frtm_tpu.data.image.imwrite wrote (PIL's defaults:
              quality 75, 4:2:0), of the arrays `imwrite_source` rebuilds:
              colour and grey at 480x854, colour at 720x1280 and at 37x53;
  png_forms/  a PNG of every colour type at every bit depth the format
              allows, non-interlaced and Adam7 (`encode_png_samples`, this
              script's own writer, all five row filters), and the forms PIL
              writes for 1-bit and 16-bit grey and 2- and 4-bit palettes;
  davis_2bit/ the DAVIS annotations again, saved by PIL with a 3-colour
              palette, which it writes at 2 bits a pixel;
  manifest.json  per JPEG the sha256 of PIL's decoded pixels and the PSNR of
              that decode against the source frame, per PNG the sha256 of its
              pixels and the filter types its rows use; under `imwrite`,
              `png_forms` and `davis_2bit` per file also the sha256 of its
              bytes, and per PNG the pixels' sha256 as frtm_tpu's imread
              reads them (its libpng path for grey at 8 bits or fewer).

    python scripts/make_torch_jpeg_fixtures.py [--out tests/data/torch_fixtures]

PIL and OpenCV write the files, and frtm_tpu (the JAX package) writes and
reads the newer ones; `source_frame`, `label_frame`, `imwrite_source`,
`png_form_samples` and `encode_png_samples` are numpy only, so that a check
on a machine without PIL can rebuild the source frames and measure its own
decoder's PSNR. The content is smooth with little noise, which keeps the
committed files small. Only the trees named above and the manifest are
rewritten; other files under --out (models/) stay.
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
TREES = ("davis", "ytvos", "coverage", "imwrite", "png_forms", "davis_2bit")
# imwrite/: name -> (colour or grey, size, seed, frame)
IMWRITE = {"imwrite/colour_480x854.jpg": ("colour", DAVIS_SIZE, 4, 0),
           "imwrite/grey_480x854.jpg": ("grey", DAVIS_SIZE, 4, 1),
           "imwrite/colour_720x1280.jpg": ("colour", YTVOS_SIZE, 5, 0),
           "imwrite/colour_37x53.jpg": ("colour", (37, 53), 6, 0)}
# PNG colour type -> (name, samples per pixel, bit depths)
PNG_FORMS = {0: ("grey", 1, (1, 2, 4, 8, 16)), 2: ("rgb", 3, (8, 16)),
             3: ("palette", 1, (1, 2, 4, 8)), 4: ("grey_alpha", 2, (8, 16)),
             6: ("rgba", 4, (8, 16))}
PNG_FORM_SIZE = (37, 53)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


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


def imwrite_source(name: str) -> np.ndarray:
    """The array an imwrite/ JPEG was written from: (H, W, 3) or, for grey,
    (H, W), the green channel."""
    kind, size, seed, t = IMWRITE[name]
    frame = source_frame(t, size, seed=seed)
    return frame if kind == "colour" else np.ascontiguousarray(frame[..., 1])


def png_form_samples(ctype, depth, size=PNG_FORM_SIZE) -> np.ndarray:
    """(H, W, C) samples of a png_forms/ file: diagonal ramps over every value
    of the bit depth (at most 16 palette entries), a different one per
    channel."""
    _, c, _ = PNG_FORMS[ctype]
    yy, xx = np.mgrid[0:size[0], 0:size[1]]
    levels = min(1 << depth, 16) if ctype == 3 else 1 << depth
    step = max(1, levels // 64)
    return np.stack([((yy * 3 + xx * 5 + 11 * k) * step) % levels for k in range(c)],
                    -1).astype(np.uint16 if depth == 16 else np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_filter_rows(packed, bpp, ftypes) -> bytes:
    """Each row of packed bytes filtered by ftypes[y % len(ftypes)] (the
    predictors read the unfiltered bytes), with its filter byte in front."""
    h, s = packed.shape
    cur = packed.astype(np.int64)
    up = np.concatenate([np.zeros((1, s), np.int64), cur[:-1]])
    left = np.concatenate([np.zeros((h, bpp), np.int64), cur], axis=1)[:, :s]
    upleft = np.concatenate([np.zeros((h, bpp), np.int64), up], axis=1)[:, :s]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = {0: 0 * cur, 1: left, 2: up, 3: (left + up) // 2, 4: paeth}
    out = bytearray()
    for y in range(h):
        t = ftypes[y % len(ftypes)]
        out.append(t)
        out += bytes(((cur[y] - preds[t][y]) % 256).astype(np.uint8))
    return bytes(out)


def encode_png_samples(samples, depth, ctype, interlace=0, ftypes=(0, 1, 2, 3, 4),
                       palette=None) -> bytes:
    """A PNG of (H, W, C) samples at any bit depth: sub-byte samples packed
    most significant first with each row padded to a byte, 16-bit ones
    big-endian; interlace 1 writes the seven Adam7 passes, each filtered on
    its own. PIL writes no interlaced PNG (it ignores interlace=1)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.reshape(sub.shape[0], -1).astype(np.int64)
        if depth == 16:
            packed = rows.astype(">u2").view(np.uint8)
        elif depth == 8:
            packed = rows.astype(np.uint8)
        else:
            bits = (rows[..., None] >> np.arange(depth - 1, -1, -1)) & 1
            packed = np.packbits(bits.reshape(rows.shape[0], -1).astype(np.uint8), axis=1)
        raw += png_filter_rows(packed, max(1, depth * c // 8), ftypes)
    plte = b"" if palette is None else _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + plte + _png_chunk(b"IDAT", zlib.compress(raw, 9)) + _png_chunk(b"IEND", b""))


def png_form_pixels(ctype, depth, samples) -> np.ndarray:
    """What frtm_tpu's imread returns for a PNG of these samples: palette
    indices and grey at 8 bits or fewer as they are (libpng), 16-bit grey as
    uint16, other 16-bit forms as PIL's 8-bit modes (the high byte; grey +
    alpha widened to RGBA)."""
    if depth != 16 or ctype == 0:
        return samples
    hi = (samples >> 8).astype(np.uint8)
    return hi[..., [0, 0, 0, 1]] if ctype == 4 else hi


def _file_sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


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
    for tree in TREES:
        if (out / tree).exists():
            shutil.rmtree(out / tree)
    manifest = {"quality": QUALITY, "jpeg": {}, "png": {}, "imwrite": {}, "png_forms": {},
                "davis_2bit": {}}

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

    write_image_io_fixtures(out, manifest)
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for tree in TREES for p in (out / tree).rglob("*")
                if p.is_file()) + (out / "manifest.json").stat().st_size
    print(f"wrote {out}: {total} bytes")


def write_image_io_fixtures(out, manifest):
    """imwrite/, png_forms/ and davis_2bit/ with their manifest entries,
    written and read by frtm_tpu (the JAX package's image module)."""
    from PIL import Image
    from frtm_tpu.data import image as jax_image
    from frtm_tpu.utils import native as jax_native
    if not jax_native.available():
        raise SystemExit("frtm_tpu's host library did not build: its libpng path reads "
                         "the sub-byte grey PNGs")

    for name in IMWRITE:
        path, src = out / name, imwrite_source(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        jax_image.imwrite(path, src)
        with Image.open(path) as pil:
            dec = np.asarray(pil.convert("RGB"))
        rgb = src if src.ndim == 3 else np.repeat(src[..., None], 3, -1)
        manifest["imwrite"][name] = {"shape": list(dec.shape), "sha256": _sha(dec),
                                     "sha256_file": _file_sha(path), "psnr_db": psnr(dec, rgb)}

    def record_png(path, ctype, depth, interlace, writer, want):
        got = jax_image.imread(path)
        if ctype == 0 and depth < 8:        # frtm_tpu's libpng path, whatever the fallback
            got = jax_native.read_png_index(path)[..., None]
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise SystemExit(f"{path}: frtm_tpu reads {got.dtype} {got.shape}, not the samples")
        manifest["png_forms"][path.relative_to(out).as_posix()] = {
            "colour_type": ctype, "bit_depth": depth, "interlace": interlace, "writer": writer,
            "shape": list(got.shape), "dtype": str(got.dtype), "sha256": _sha(got),
            "sha256_file": _file_sha(path)}

    root = out / "png_forms"
    root.mkdir(parents=True)
    palette = np.stack([np.arange(16) * 16, 255 - np.arange(16) * 16, np.arange(16) * 5], -1)
    for ctype, (form, _, depths) in PNG_FORMS.items():
        for depth in depths:
            samples = png_form_samples(ctype, depth)
            for interlace in (0, 1):
                path = root / f"{form}{depth}{'_adam7' if interlace else ''}.png"
                path.write_bytes(encode_png_samples(
                    samples, depth, ctype, interlace,
                    palette=palette[:min(1 << depth, 16)] if ctype == 3 else None))
                record_png(path, ctype, depth, interlace, "script",
                           png_form_pixels(ctype, depth, samples))
    # the forms PIL chooses itself: mode 1, I;16, and a palette of 3 or 16 colours
    for name, ctype, depth, samples in (
            ("grey1_pil.png", 0, 1, png_form_samples(0, 1)),
            ("grey16_pil.png", 0, 16, png_form_samples(0, 16)),
            ("palette2_pil.png", 3, 2, png_form_samples(3, 2) % 3),
            ("palette4_pil.png", 3, 4, png_form_samples(3, 4))):
        if ctype == 3:
            im = Image.fromarray(samples[..., 0], "P")
            im.putpalette(palette[:3 if depth == 2 else 16].ravel().tolist())
        else:
            im = Image.fromarray(samples[..., 0].astype(bool if depth == 1 else np.uint16))
        im.save(root / name)
        if _png_header(root / name)[2:4] != (depth, ctype):
            raise SystemExit(f"{name}: PIL wrote {_png_header(root / name)}")
        record_png(root / name, ctype, depth, 0, "pil", samples)

    # the DAVIS annotations with a 3-colour palette: 2 bits a pixel
    for t in range(N_FRAMES):
        path = out / "davis_2bit" / "Annotations" / "480p" / DAVIS_SEQ / f"{t:05d}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        lb = label_frame(t, DAVIS_SIZE)
        img = Image.fromarray(lb, "P")
        img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0])
        img.save(path)
        if _png_header(path)[2:4] != (2, 3):
            raise SystemExit(f"{path}: PIL wrote {_png_header(path)}, not a 2-bit palette")
        got = jax_image.imread(path)
        if not np.array_equal(got[..., 0], lb):
            raise SystemExit(f"{path}: frtm_tpu does not read the labels back")
        manifest["davis_2bit"][path.relative_to(out).as_posix()] = {
            "shape": list(got.shape), "sha256": _sha(got), "sha256_file": _file_sha(path),
            "bit_depth": 2}


def _png_header(path):
    """(width, height, bit depth, colour type, compression, filter, interlace)."""
    return struct.unpack(">IIBBBBB", Path(path).read_bytes()[16:29])


if __name__ == "__main__":
    main()
