"""Image IO (frtm_tpu/data/image.py): reading frames and annotations,
writing label images as indexed-colour PNGs with the DAVIS palette, which is
what the DAVIS tooling reads, and writing greyscale, RGB and RGBA images as
PNG (`imwrite`). (H, W, C) numpy arrays throughout.

Nothing here needs PIL, cv2 or libpng's headers, none of which the port may
assume. PNG goes through this module's own codec: chunks and inflation with
`zlib` and `struct` from the standard library, the row unfilter in the port's
host library (utils/native.py; `_unfilter_plain` is its plain version). It
writes 8-bit PNG, indexed with a PLTE chunk or greyscale, grey + alpha, RGB
and RGBA, every row unfiltered; it reads non-interlaced 8-bit PNG
of every colour type (greyscale, RGB, indexed, and both with alpha) with all
five scanline filters (None, Sub, Up, Average, Paeth: other writers choose a
filter per row), and raises on what it does not read (16-bit samples, bit
depths under 8, interlacing). An indexed PNG is read as its indices,
(H, W, 1), like a label image.

JPEG is decoded by the host library too (libjpeg or nvJPEG, whichever its
build found; `native.JPEG_BACKEND`), always to (H, W, 3) RGB; `imread_batch`
decodes same-size JPEG frames on its pool of threads.
"""
import struct
import zlib
from pathlib import Path

import numpy as np

from ..utils import native

# 256-entry palette; the first 22 are the DAVIS colours, the rest a grey ramp.
davis_palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
davis_palette[:22] = [
    [0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0],
    [0, 0, 128], [128, 0, 128], [0, 128, 128], [128, 128, 128],
    [64, 0, 0], [191, 0, 0], [64, 128, 0], [191, 128, 0],
    [64, 0, 128], [191, 0, 128], [64, 128, 128], [191, 128, 128],
    [0, 64, 0], [128, 64, 0], [0, 191, 0], [128, 191, 0],
    [0, 64, 128], [128, 64, 128],
]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel by PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png_indexed(labels, palette) -> bytes:
    """The bytes of an 8-bit indexed PNG: (H, W) indices, (<= 256, 3) palette."""
    labels = np.ascontiguousarray(labels, np.uint8)
    if labels.ndim != 2:
        raise ValueError(f"encode_png_indexed: expected (H, W) labels, got {labels.shape}")
    palette = np.ascontiguousarray(palette, np.uint8)
    if palette.ndim != 2 or palette.shape[1] != 3 or not 1 <= palette.shape[0] <= 256:
        raise ValueError(f"encode_png_indexed: palette shape {palette.shape}")
    h, w = labels.shape
    return _encode_png(labels, w, h, 3, _chunk(b"PLTE", palette.tobytes()))


# PNG colour type by samples per pixel: grey, grey + alpha, RGB, RGBA
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def encode_png(im) -> bytes:
    """The bytes of an 8-bit PNG of a (H, W) or (H, W, C) uint8 image, C = 1
    (greyscale), 2 (grey + alpha), 3 (RGB) or 4 (RGBA)."""
    im = np.asarray(im)
    if im.dtype != np.uint8:
        raise TypeError(f"encode_png: expected uint8, got {im.dtype}")
    if im.ndim == 2:
        im = im[..., None]
    if im.ndim != 3 or im.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"encode_png: expected (H, W) or (H, W, 1-4), got {im.shape}")
    h, w, c = im.shape
    return _encode_png(np.ascontiguousarray(im).reshape(h, w * c), w, h, _COLOUR_TYPE[c])


def _encode_png(rows, w, h, ctype, extra=b"") -> bytes:
    """A PNG of (h, w * samples) uint8 rows, each written with filter None."""
    data = np.zeros((h, rows.shape[1] + 1), np.uint8)
    data[:, 1:] = rows
    return (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + extra
            + _chunk(b"IDAT", zlib.compress(data.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth_row(line, prev, bpp):
    out = bytearray(line)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(line, prev, bpp):
    out = bytearray(line)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prev[i]) >> 1)) & 0xFF
    return out


def _unfilter_plain(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: (height, stride) uint8. The plain
    version of native.png_unfilter."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of image data, expected "
                         f"{height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line
        elif ftype == 1:        # Sub: a running sum per sample, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:        # Up
            cur = line + prev
        elif ftype == 3:
            cur = np.frombuffer(_average_row(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif ftype == 4:
            cur = np.frombuffer(_paeth_row(line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 from the bytes of a non-interlaced 8-bit PNG; C is 1
    for greyscale and for indexed colour (the indices), 3 for RGB, 2 and 4
    with alpha."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG: truncated chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"PNG: bit depth {depth} is not supported (8 only)")
    if interlace != 0:
        raise ValueError("PNG: interlaced files are not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG: unknown colour type {ctype}")
    c = _CHANNELS[ctype]
    return native.png_unfilter(zlib.decompress(b"".join(idat)), h, w * c, c).reshape(h, w, c)


def _is_jpeg(filename) -> bool:
    return Path(filename).suffix.lower() in (".jpg", ".jpeg")


def imread(filename) -> np.ndarray:
    """Read an image to (H, W, C) uint8: C = 1 for indexed and grey label
    PNGs, 3 for every JPEG."""
    suffix = Path(filename).suffix.lower()
    if suffix == ".png":
        return decode_png(Path(filename).read_bytes())
    if _is_jpeg(filename):
        return native.decode_jpeg_file(filename)
    raise ValueError(f"imread: unsupported file type {suffix!r} ({filename})")


def imread_batch(filenames):
    """Read many same-size frames into one (N, H, W, C) array; JPEG frames of
    the first one's size are decoded together on the host library's threads."""
    filenames = list(filenames)
    if filenames and all(_is_jpeg(f) for f in filenames):
        size = native.jpeg_dims(filenames[0])
        if all(native.jpeg_dims(f) == size for f in filenames[1:]):
            return native.batch_decode_jpeg_files(filenames, *size)
    return np.stack([imread(f) for f in filenames])


def imwrite_indexed(filename, labels, color_palette=None):
    """Write a (H, W[, 1]) label image as an indexed-colour PNG."""
    palette = davis_palette if color_palette is None else color_palette
    labels = np.asarray(labels, np.uint8)
    if labels.ndim == 3 and labels.shape[2] == 1:
        labels = labels[..., 0]
    Path(filename).write_bytes(encode_png_indexed(labels, palette))


def imwrite(filename, im):
    """Write a uint8 image, (H, W), (H, W, 1), (H, W, 3) or (H, W, 4), as PNG;
    the counterpart of frtm_tpu/data/image.py::imwrite for PNG files. Other
    formats (JPEG) are not written: they raise."""
    if Path(filename).suffix.lower() != ".png":
        raise ValueError(f"imwrite writes PNG only (a .png file name), got {filename}")
    Path(filename).write_bytes(encode_png(im))
