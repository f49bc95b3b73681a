"""Image IO (frtm_tpu/data/image.py): reading frames and annotations,
writing label images as indexed-colour PNGs with the DAVIS palette, which is
what the DAVIS tooling reads, and writing images as PNG or JPEG (`imwrite`).
(H, W, C) numpy arrays throughout.

Nothing here needs PIL, cv2, libpng's or libjpeg's headers, none of which the
port may assume. PNG goes through this module's own codec: chunks and
inflation with `zlib` and `struct` from the standard library; the row
unfilter, the unpacking of 1-, 2- and 4-bit samples and the Adam7
de-interlacing in the port's host library (utils/native.py;
`png_samples_plain` is its plain version). It writes 8-bit PNG, indexed with
a PLTE chunk or greyscale, grey + alpha, RGB and RGBA, every row unfiltered;
it reads every PNG the specification allows (each colour type at each of
its bit depths, interlaced or not, with all five scanline filters) to what
frtm_tpu's `imread` returns for it:
  * indexed colour (1, 2, 4, 8 bits) as its indices and greyscale at 8 bits
    or fewer as its raw samples (a 2-bit file reads 0-3), (H, W, 1) uint8,
    as libpng gives them to frtm_tpu's host library;
  * 16-bit greyscale as (H, W, 1) uint16;
  * 8-bit RGB, grey + alpha and RGBA as (H, W, 3), (H, W, 2), (H, W, 4)
    uint8, and their 16-bit forms as PIL reads them: the high byte of each
    sample, grey + alpha widened to RGBA (grey in R, G and B).

JPEG is decoded by the host library too (libjpeg or nvJPEG, whichever its
build found; `native.JPEG_BACKEND`), always to (H, W, 3) RGB; `imread_batch`
decodes same-size JPEG frames on its pool of threads. JPEG is written by the
host library's own baseline encoder (`native.encode_jpeg`; `encode_jpeg_plain`
is its plain version): IJG's integer arithmetic step by step, so that a file
is byte for byte the one that frtm_tpu's `imwrite` writes through PIL and
libjpeg at PIL's defaults (quality 75, 4:2:0, the Annex K Huffman tables).
"""
import struct
import threading
import zlib
from collections import deque
from pathlib import Path

import numpy as np

from ..utils import native, profiling

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
    """A PNG of (h, w * samples) uint8 rows, each written with filter None
    (compressed from the array's own buffer: no copy to bytes first)."""
    data = np.empty((h, rows.shape[1] + 1), np.uint8)
    data[:, 0] = 0
    data[:, 1:] = rows
    return (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + extra
            + _chunk(b"IDAT", zlib.compress(data, 6))
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


def _unfilter_plain(raw: bytes, pos: int, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters of the `height` rows of (1 filter byte
    + `stride` bytes) at byte `pos` of raw: (height, stride) uint8."""
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = pos + y * (stride + 1)
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
            raise ValueError(f"PNG: unknown filter type {ftype} at byte {start} of the image data")
        out[y] = cur
        prev = out[y]
    return out


# bit depths the PNG specification allows for each colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_passes(h, w, interlace):
    """(x0, y0, dx, dy, rows, columns) of each sub-image the image data holds
    in order: the whole image, or the non-empty Adam7 passes."""
    out = []
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        rows, cols = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
        if rows > 0 and cols > 0:
            out.append((x0, y0, dx, dy, rows, cols))
    return out


def _unpack_plain(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """The first n samples of each unfiltered row: uint8 for depths up to 8
    (a sub-byte sample's raw value, most significant bits first), uint16 for
    16 (big-endian)."""
    if depth == 16:
        return rows.view(">u2")[:, :n].astype(np.uint16)
    if depth == 8:
        return rows[:, :n]
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :n]


def png_samples_plain(raw: bytes, h: int, w: int, depth: int, channels: int,
                      interlace: int) -> np.ndarray:
    """(h, w, channels) samples from a PNG's inflated image data, uint8 (depth
    1-8) or uint16 (16): each pass unfiltered on its own (a filter's byte
    step is max(1, depth * channels / 8)), unpacked and put in its place.
    The plain version of native.png_samples."""
    bpp, pos = max(1, depth * channels // 8), 0
    passes = _png_passes(h, w, interlace)
    total = sum(rows * ((cols * channels * depth + 7) // 8 + 1) for *_, rows, cols in passes)
    if len(raw) != total:
        raise ValueError(f"PNG: {len(raw)} bytes of image data, expected {total}")
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    for x0, y0, dx, dy, rows, cols in passes:
        stride = (cols * channels * depth + 7) // 8
        lines = _unfilter_plain(raw, pos, rows, stride, bpp)
        out[y0::dy, x0::dx] = _unpack_plain(lines, cols * channels, depth).reshape(
            rows, cols, channels)
        pos += rows * (stride + 1)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) from the bytes of a PNG, as frtm_tpu's `imread` reads it
    (the module's docstring): uint8, or uint16 for 16-bit greyscale."""
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
    if not (0 < w < 2 ** 31 and 0 < h < 2 ** 31):
        raise ValueError(f"PNG: a size of {w}x{h} is outside the format's 1 to 2^31 - 1")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG: unknown colour type {ctype}")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG: bit depth {depth} is not allowed for colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"PNG: unknown interlace method {interlace}")
    c = _CHANNELS[ctype]
    im = native.png_samples(zlib.decompress(b"".join(idat)), h, w, depth, c, interlace)
    if depth == 16 and ctype != 0:      # PIL's 8-bit modes: the high byte
        im = (im >> 8).astype(np.uint8)
        if ctype == 4:
            im = im[..., [0, 0, 0, 1]]
    return im


# ---------------------------------------------------------------------------
# JPEG writing: a baseline encoder on IJG's integer arithmetic (libjpeg's
# jccolor.c, jcsample.c, jfdctint.c, jcdctmgr.c, jchuff.c, jcmarker.c), in
# numpy for the blocks and Python for the entropy coder. The host library's
# encode_jpeg is the same algorithm in C++; the two give the same bytes.

# the natural (row-major) index of each zigzag position (jpeg_natural_order)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K's quantisation tables (luminance, chrominance), natural order
_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32])
# Annex K's Huffman tables: (code counts by length 1-16, symbols) for the DC
# and AC coefficients of luminance (table 0) and chrominance (table 1)
_HUFF_DC = [(bytes.fromhex("00 01 05 01 01 01 01 01 01 00 00 00 00 00 00 00"), bytes(range(12))),
            (bytes.fromhex("00 03 01 01 01 01 01 01 01 01 01 00 00 00 00 00"), bytes(range(12)))]
_HUFF_AC = [
    (bytes.fromhex("00 02 01 03 03 02 04 03 05 05 04 04 00 00 01 7d"), bytes.fromhex(
        "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 a1 08 23 42 b1 c1"
        " 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a 25 26 27 28 29 2a 34 35 36 37 38 39"
        " 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75"
        " 76 77 78 79 7a 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7"
        " a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8"
        " d9 da e1 e2 e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8 f9 fa")),
    (bytes.fromhex("00 02 01 02 04 04 03 04 07 05 04 04 00 01 02 77"), bytes.fromhex(
        "00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 42 91 a1 b1 c1 09"
        " 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17 18 19 1a 26 27 28 29 2a 35 36 37 38"
        " 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74"
        " 75 76 77 78 79 7a 82 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5"
        " a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6"
        " d7 d8 d9 da e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8 f9 fa"))]


# the tables at quality 75: jpeg_quality_scaling's 50 % of Annex K's, every
# entry within 1..255 without clamping
_QUANT_75 = (_QUANT * 50 + 50) // 100


def _huffman_codes(counts: bytes, symbols: bytes) -> dict:
    """symbol -> (code, length) of a canonical Huffman table."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


_FIX_BITS = 16


def _fix(x):
    return int(x * (1 << _FIX_BITS) + 0.5)


def _ycc_plain(rgb: np.ndarray) -> np.ndarray:
    """jccolor.c's RGB -> YCbCr in 16-bit fixed point, (..., 3) uint8."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    half, centre = 1 << (_FIX_BITS - 1), 128 << _FIX_BITS
    y = _fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half
    # Cb and Cr round with 0.5 - epsilon, so that 255 is their largest value
    cb = -_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + centre + half - 1
    cr = _fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + centre + half - 1
    return (np.stack([y, cb, cr], -1) >> _FIX_BITS).astype(np.uint8)


def _edge_pad(plane, rows, cols):
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def _downsample_h2v2(plane):
    """jcsample.c's h2v2_downsample of an even-sized plane: each 2x2 sum plus
    a bias of 1 and 2 in turn along the row, shifted right by 2."""
    p = plane.astype(np.int32)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return ((s + bias) >> 2).astype(np.uint8)


def _blocks(plane):
    """(rows / 8, cols / 8, 8, 8) blocks of a plane whose sides are multiples of 8."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d, first):
    """One pass of jfdctint.c's jpeg_fdct_islow along the last axis of d:
    CONST_BITS 13, PASS1_BITS 2; the first pass leaves its outputs scaled up
    by 4, the second removes it."""
    cb, p1 = 13, 2
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    shift = cb - p1 if first else cb + p1
    out = [None] * 8
    out[0] = (t10 + t11) << p1 if first else _descale(t10 + t11, p1)
    out[4] = (t10 - t11) << p1 if first else _descale(t10 - t11, p1)
    z1 = (t12 + t13) * 4433                                    # FIX(0.541196100)
    out[2] = _descale(z1 + t13 * 6270, shift)                  # FIX(0.765366865)
    out[6] = _descale(z1 - t12 * 15137, shift)                 # FIX(1.847759065)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * 9633                                      # FIX(1.175875602)
    t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    out[7] = _descale(t4 + z1 + z3, shift)
    out[5] = _descale(t5 + z2 + z4, shift)
    out[3] = _descale(t6 + z2 + z3, shift)
    out[1] = _descale(t7 + z1 + z4, shift)
    return np.stack(out, -1)


def _quantised_blocks_plain(plane, quant) -> np.ndarray:
    """(rows / 8, cols / 8, 64) quantised DCT coefficients, zigzag order, of a
    uint8 plane whose sides are multiples of 8: samples centred on 0,
    jpeg_fdct_islow (rows, then columns), then jcdctmgr.c's division by
    8 * quant rounding half away from zero."""
    d = _blocks(plane).astype(np.int64) - 128
    d = _fdct_pass(_fdct_pass(d, True).swapaxes(-1, -2), False).swapaxes(-1, -2)
    d = d.reshape(d.shape[:2] + (64,))
    div = np.asarray(quant, np.int64) * 8
    q = (np.abs(d) + div // 2) // div
    return (np.sign(d) * q)[..., _ZIGZAG]


def _jpeg_scan_blocks(im, quant):
    """The blocks of the scan in order, each a list of 64 coefficients in
    zigzag order, with each block's component. Greyscale: one component, its
    blocks row by row. Colour: 16x16 MCUs of four Y blocks, one Cb and one
    Cr, Y's blocks beyond the image dummies with no AC and the DC of the
    block before them (jccoefct.c)."""
    h, w = im.shape[:2]
    if im.ndim == 2:
        plane = _edge_pad(im, -(-h // 8) * 8, -(-w // 8) * 8)
        z = _quantised_blocks_plain(plane, quant[0])
        return z.reshape(-1, 64).tolist(), [0] * (z.shape[0] * z.shape[1])
    mr, mc = -(-h // 16), -(-w // 16)
    ycc = _ycc_plain(im)
    yb = _quantised_blocks_plain(
        _edge_pad(ycc[..., 0], -(-h // 8) * 8, -(-w // 8) * 8), quant[0])
    y = np.zeros((2 * mr, 2 * mc, 64), np.int64)
    hb, wb = yb.shape[:2]
    y[:hb, :wb] = yb
    if wb < 2 * mc:                     # a dummy column: the DC of the block on its left
        y[:hb, wb, 0] = y[:hb, wb - 1, 0]
    if hb < 2 * mr:                     # a dummy row: the DC of its MCU's upper right block
        y[hb, :, 0] = np.repeat(y[hb - 1, 1::2, 0], 2)
    chroma = []
    for k in (1, 2):
        # rows and columns made even by repeating the last, downsampled, then
        # repeated again to whole blocks
        plane = _downsample_h2v2(_edge_pad(ycc[..., k], 2 * -(-h // 2), 16 * mc))
        chroma.append(_quantised_blocks_plain(_edge_pad(plane, 8 * mr, 8 * mc), quant[1]))
    mcus = np.concatenate([y.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        mr, mc, 4, 64), chroma[0][:, :, None], chroma[1][:, :, None]], axis=2)
    return mcus.reshape(-1, 64).tolist(), [0, 0, 0, 0, 1, 2] * (mr * mc)


def _jpeg_entropy_plain(blocks, comps, tables) -> bytes:
    """jchuff.c's baseline Huffman coding of the blocks in order: DC as the
    difference to the component's last DC, AC as runs of zeros (ZRL for 16)
    and EOB; 0xFF bytes followed by 0x00, the last byte filled with 1 bits."""
    out = bytearray()
    acc = nacc = 0
    last_dc = [0, 0, 0]

    def emit(code, size):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    def emit_value(v, nbits):
        if nbits:
            emit((v if v >= 0 else v - 1) & ((1 << nbits) - 1), nbits)

    for block, comp in zip(blocks, comps):
        dc_codes, ac_codes = tables[min(comp, 1)]
        diff = block[0] - last_dc[comp]
        last_dc[comp] = block[0]
        nbits = abs(diff).bit_length()
        emit(*dc_codes[nbits])
        emit_value(diff, nbits)
        run = 0
        for v in block[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                emit(*ac_codes[0xF0])
                run -= 16
            nbits = abs(v).bit_length()
            emit(*ac_codes[(run << 4) | nbits])
            emit_value(v, nbits)
            run = 0
        if run:
            emit(*ac_codes[0x00])
    if nacc:
        emit((1 << (8 - nacc)) - 1, 8 - nacc)
    return bytes(out)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _jpeg_headers(h: int, w: int, components: int, quant) -> bytes:
    """SOI, JFIF 1.01 APP0 (no units, 1:1), DQT per table, SOF0, DHT per
    table, SOS: the markers jcmarker.c writes in its order for a baseline
    scan of one (grey) or three (Y 2x2, Cb, Cr) components."""
    ntab = 1 if components == 1 else 2
    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\0" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))
    for t in range(ntab):
        out += _segment(0xDB, bytes([t]) + bytes(np.asarray(quant[t], np.uint8)[_ZIGZAG]))
    comps = [(1, 0x11, 0)] if components == 1 else [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    out += _segment(0xC0, struct.pack(">BHHB", 8, h, w, components)
                    + b"".join(bytes(c) for c in comps))
    for t in range(ntab):
        for cls, (counts, symbols) in ((0, _HUFF_DC[t]), (1, _HUFF_AC[t])):
            out += _segment(0xC4, bytes([cls << 4 | t]) + counts + symbols)
    return out + _segment(0xDA, bytes([components]) + b"".join(
        bytes([cid, tab << 4 | tab]) for cid, _, tab in comps) + bytes([0, 63, 0]))


def encode_jpeg_plain(im) -> bytes:
    """The bytes of a baseline JPEG of a (H, W) greyscale or (H, W, 3) RGB
    uint8 image, as libjpeg writes it with PIL's defaults (quality 75, 4:2:0
    for colour, islow DCT, Annex K Huffman tables). The plain version of
    native.encode_jpeg."""
    im = _jpeg_input(im)
    quant = _QUANT_75
    tables = [(_huffman_codes(*_HUFF_DC[t]), _huffman_codes(*_HUFF_AC[t])) for t in (0, 1)]
    blocks, comps = _jpeg_scan_blocks(im, quant)
    return (_jpeg_headers(im.shape[0], im.shape[1], 1 if im.ndim == 2 else 3, quant)
            + _jpeg_entropy_plain(blocks, comps, tables) + b"\xff\xd9")


def _jpeg_input(im) -> np.ndarray:
    im = np.ascontiguousarray(im)
    if im.dtype != np.uint8:
        raise TypeError(f"JPEG: expected uint8 samples, got {im.dtype}")
    if not (im.ndim == 2 or (im.ndim == 3 and im.shape[2] == 3)) or 0 in im.shape:
        raise ValueError(f"JPEG: expected a (H, W) or (H, W, 3) image, got {im.shape}")
    if max(im.shape[:2]) > 65535:
        raise ValueError(f"JPEG: {im.shape[:2]} is larger than 65535 on a side")
    return im


def jpeg_image(im) -> np.ndarray:
    """What frtm_tpu's imwrite hands PIL for a JPEG, made explicit:
    `np.asarray(im).squeeze()` as PIL's fromarray reads it ((H, W) greyscale,
    (H, W, 3) RGB, a vector (N,) as N rows of one column, bool as 0 / 255);
    two and four channels raise, as PIL cannot write LA or RGBA as JPEG."""
    im = np.asarray(im).squeeze()
    if im.ndim == 0:
        raise ValueError("JPEG: a single value is not an image")
    if im.dtype == bool:                # PIL's mode 1 is one channel only
        if im.ndim > 2:
            raise TypeError(f"JPEG: cannot write bool samples of shape {im.shape}")
        im = im.astype(np.uint8) * 255
    if im.ndim == 1:
        im = im[:, None]
    if im.ndim == 3 and im.shape[2] in (2, 4):
        raise ValueError(f"cannot write {'LA' if im.shape[2] == 2 else 'RGBA'} as JPEG "
                         f"(an image of {im.shape[2]} channels)")
    return _jpeg_input(im)


def _is_jpeg(filename) -> bool:
    return Path(filename).suffix.lower() in (".jpg", ".jpeg")


def imread(filename) -> np.ndarray:
    """Read an image to (H, W, C): uint8, or uint16 for 16-bit grey PNGs;
    C = 1 for indexed and grey PNGs, 3 for every JPEG (the module's docstring
    has every PNG form)."""
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


class LabelWriter:
    """Writes sequences' label PNGs on background threads while the caller
    goes on, so that a tracking loop does not wait for `zlib`, which
    releases the interpreter lock while it compresses.

        with LabelWriter() as writer:
            for ...:
                writer.put(dst, labels, frame_names)   # dst/<name>.png

    THREADS threads take the frames of the oldest sequence handed off, one
    file at a time, each through `write(path, labels)` (`imwrite_indexed`
    unless given), so the files are those the serial loop writes. `put`
    waits while DEPTH sequences are handed off and not yet written in full.
    Leaving the block (or `close()`) waits for every file handed off and
    joins the threads; a write's exception is raised on the caller's thread
    at the next `put` or at the close, and the files not yet written are
    dropped. Where the recorder is on, each thread's stretch of a
    sequence's writes is a span `png_encode` of the request that handed the
    sequence off."""

    THREADS = 2
    DEPTH = 2

    def __init__(self, write=None):
        self._write = imwrite_indexed if write is None else write
        self._cv = threading.Condition()
        self._todo = deque()    # sequences with files no thread has taken yet
        self._held = 0          # sequences handed off and not yet written in full
        self._closing = False
        self._error = None
        self._threads = []

    def __enter__(self):
        self._threads = [threading.Thread(target=self._work, name=f"label-writer-{i}",
                                          daemon=True) for i in range(self.THREADS)]
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, kind, exc, tb):
        try:
            self.close()
        except Exception:
            if exc is None:
                raise

    def put(self, dst, labels, names):
        """Hand off one sequence: labels[i] is written to dst/<names[i]>.png."""
        job = _Sequence(deque((Path(dst) / (f + ".png"), lb) for lb, f in zip(labels, names)),
                        profiling.current_request())
        with self._cv:
            if self._closing:
                raise RuntimeError("LabelWriter.put after close")
            while self._held >= self.DEPTH and self._error is None:
                self._cv.wait()
            self._raise()
            if job.left:
                self._held += 1
                self._todo.append(job)
                self._cv.notify_all()

    def close(self):
        """Wait for every file handed off, join the threads, raise a write's
        exception; called again, it only raises that again."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []
        with self._cv:
            self._raise()

    def _raise(self):
        if self._error is not None:
            raise self._error

    def _take(self, job):
        """The next (path, labels) of `job`, else None (with the lock held).
        A sequence leaves the queue with its last file taken, so the job
        with files left is the oldest."""
        if self._error is not None or not job.files:
            return None
        item = job.files.popleft()
        if not job.files:
            self._todo.popleft()
        return item

    def _work(self):
        while True:
            with self._cv:
                while not self._todo and not self._closing:
                    self._cv.wait()
                if not self._todo:
                    return
                job = self._todo[0]
                item = self._take(job)
            with profiling.span("png_encode", request=job.request):
                while item is not None:
                    try:
                        self._write(*item)
                    except Exception as e:
                        with self._cv:
                            self._error = self._error or e
                            self._todo.clear()
                            self._cv.notify_all()
                        return
                    with self._cv:
                        job.left -= 1
                        if not job.left:
                            self._held -= 1
                            self._cv.notify_all()
                        item = self._take(job)


class _Sequence:
    """A sequence handed to a LabelWriter: the files no thread has taken,
    how many are not yet written, the request that handed it off."""
    __slots__ = ("files", "left", "request")

    def __init__(self, files, request):
        self.files, self.left, self.request = files, len(files), request


def imwrite(filename, im):
    """Write an image as frtm_tpu/data/image.py::imwrite does, by its suffix:
    PNG, uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4); JPEG (.jpg, .jpeg
    in any case), the bytes frtm_tpu writes (`jpeg_image` says which arrays,
    `native.encode_jpeg` how). Other formats raise."""
    if _is_jpeg(filename):
        Path(filename).write_bytes(native.encode_jpeg(jpeg_image(im)))
        return
    if Path(filename).suffix.lower() != ".png":
        raise ValueError(f"imwrite writes PNG and JPEG only (.png, .jpg, .jpeg), got {filename}")
    Path(filename).write_bytes(encode_png(im))
