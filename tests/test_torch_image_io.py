"""The port's PNG codec (frtm_tpu_torch/data/image.py, standard library only)
against PIL and against frtm_tpu.data.image: what it writes, PIL and the JAX
package read as the same indexed image with the DAVIS palette; what they
write, and what libpng writes through OpenCV (indexed, grey, grey + alpha, RGB,
RGBA; odd widths; all five scanline filter types), it reads equal, value for value; what it does not read raises.
Every bit depth and Adam7: test_torch_image_formats.py.
"""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from frtm_tpu.data import image as jax_image
from frtm_tpu_torch.data import image as port_image
from frtm_tpu_torch.data.image import (davis_palette, decode_png, encode_png_indexed, imread,
                                       imread_batch, imwrite_indexed)


def _labels(rng, h, w, n=5):
    lb = np.zeros((h, w), np.uint8)
    for k in range(1, n + 1):
        y, x = rng.randint(0, h), rng.randint(0, w)
        lb[y:y + rng.randint(1, h + 1), x:x + rng.randint(1, w + 1)] = k
    return lb


def _filter_types(path):
    """The set of scanline filter types a PNG file uses, from its bytes."""
    data = path.read_bytes()
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
    return {raw[y * stride] for y in range(h)}


def test_palette_is_the_jax_package_s():
    np.testing.assert_array_equal(davis_palette, jax_image.davis_palette)
    assert davis_palette.shape == (256, 3) and davis_palette.dtype == np.uint8


@pytest.mark.parametrize("size", [(48, 64), (37, 53), (1, 1), (5, 131), (480, 854)])
def test_written_png_opens_in_pil_as_indexed_with_the_davis_palette(tmp_path, size):
    lb = _labels(np.random.RandomState(0), *size)
    path = tmp_path / "lb.png"
    imwrite_indexed(path, lb[..., None])            # (H, W, 1) as the trackers' callers pass
    with Image.open(path) as im:
        assert im.mode == "P" and im.size == size[::-1]
        np.testing.assert_array_equal(np.array(im), lb)
        np.testing.assert_array_equal(np.array(im.getpalette(), np.uint8).reshape(-1, 3),
                                      davis_palette)
    np.testing.assert_array_equal(jax_image.imread(path), lb[..., None])
    np.testing.assert_array_equal(imread(path), lb[..., None])
    if min(size) == 1:      # the JAX package's native writer squeezes such an image away
        return
    # the same image as the JAX package writes it
    jax_image.imwrite_indexed(tmp_path / "jax.png", lb)
    np.testing.assert_array_equal(imread(tmp_path / "jax.png"), lb[..., None])
    with Image.open(tmp_path / "jax.png") as im:
        assert im.mode == "P"


def test_custom_palette_and_bad_arguments(tmp_path):
    lb = _labels(np.random.RandomState(1), 9, 11, n=3)
    pal = np.random.RandomState(2).randint(0, 256, (4, 3)).astype(np.uint8)
    imwrite_indexed(tmp_path / "p.png", lb, pal)
    with Image.open(tmp_path / "p.png") as im:
        np.testing.assert_array_equal(np.array(im.getpalette(), np.uint8).reshape(-1, 3)[:4], pal)
        np.testing.assert_array_equal(np.array(im), lb)
    with pytest.raises(ValueError):
        encode_png_indexed(np.zeros((2, 3, 3), np.uint8), davis_palette)
    with pytest.raises(ValueError):
        encode_png_indexed(lb, np.zeros((300, 3), np.uint8))


def _smooth(rng, h, w, c):
    """Content with gradients, noise and flat parts, so that an adaptive
    encoder picks different filters for different rows."""
    yy, xx = np.mgrid[0:h, 0:w]
    chans = []
    for k in range(c):
        a = (xx * (k + 1) * 3 + yy * 2) % 256                      # ramps: Sub / Up
        a[h // 3:h // 2] = rng.randint(0, 256, (h // 2 - h // 3, w))   # noise: None
        a[h // 2:2 * h // 3] = (xx[h // 2:2 * h // 3] ** 2 // 7
                                + yy[h // 2:2 * h // 3] * xx[h // 2:2 * h // 3] // 5) % 256
        a[-h // 6:] = 17 * k                                       # flat
        chans.append(a)
    return np.stack(chans, -1).astype(np.uint8)


def _averaged(rng, h, w, c):
    """Every value is the mean of its left and upper neighbours plus 0 or 1,
    with steep edges: the Average filter leaves the smallest residual."""
    a = np.zeros((h, w, c), np.int64)
    a[0] = np.cumsum(rng.randint(-20, 21, (w, c)), axis=0)
    a[:, 0] = np.cumsum(rng.randint(-20, 21, (h, c)), axis=0)
    for y in range(1, h):
        for x in range(1, w):
            a[y, x] = (a[y, x - 1] % 256 + a[y - 1, x] % 256) // 2 + rng.randint(0, 2, c)
    return (a % 256).astype(np.uint8)


@pytest.mark.parametrize("mode,c", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
@pytest.mark.parametrize("size", [(60, 64), (61, 53)])
def test_reads_what_pil_writes(tmp_path, mode, c, size):
    rng = np.random.RandomState(3)
    # photographs, ramps and noise together use all five filter types
    seen = set()
    for i, arr in enumerate([_smooth(rng, *size, c), _averaged(rng, *size, c),
                             rng.randint(0, 256, size + (c,)).astype(np.uint8),
                             np.cumsum(rng.randint(0, 3, size + (c,)), axis=1).astype(np.uint8),
                             np.cumsum(np.cumsum(rng.randint(0, 2, size + (c,)), axis=0),
                                       axis=1).astype(np.uint8)]):
        path = tmp_path / f"{mode}{i}.png"
        Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(path)
        got = imread(path)
        assert got.shape == size + (c,) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, arr)
        seen |= _filter_types(path)
    # Pillow's own encoder (12.1 here) never picks Average; libpng does (below)
    assert seen >= {0, 1, 2, 4}, seen


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("size", [(60, 64), (61, 53)])
def test_reads_what_libpng_writes_with_all_five_filters(tmp_path, c, size):
    """OpenCV writes through libpng, whose adaptive heuristic uses every
    filter type on this content (asserted from the files' bytes)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(7)
    seen = set()
    for i, arr in enumerate([_smooth(rng, *size, c), _averaged(rng, *size, c)]):
        path = tmp_path / f"cv{i}.png"
        # at its default level OpenCV fixes the filter to Sub; with a level given
        # libpng chooses per row
        assert cv2.imwrite(str(path), arr[..., 0] if c == 1 else arr,
                           [cv2.IMWRITE_PNG_COMPRESSION, 9])
        want = arr if c == 1 else arr[..., [2, 1, 0] + [3] * (c == 4)]      # BGR(A) on disk
        np.testing.assert_array_equal(imread(path), want)
        seen |= _filter_types(path)
    assert seen == {0, 1, 2, 3, 4}, seen


def test_every_filter_type_by_hand():
    """Each filter applied by a straightforward encoder written here, on an
    RGB and a one-channel image: the decoder must undo all five, also where
    PIL's choice would not have exercised one."""
    rng = np.random.RandomState(4)
    for c, ctype in ((3, 2), (1, 0), (4, 6)):
        arr = rng.randint(0, 256, (5, 7, c)).astype(np.uint8)
        h, w = arr.shape[:2]
        flat = arr.reshape(h, w * c).astype(np.int64)
        for ftype in range(5):
            raw = bytearray()
            for y in range(h):
                row, up = flat[y], flat[y - 1] if y else np.zeros(w * c, np.int64)
                left = np.concatenate([np.zeros(c, np.int64), row[:-c]])
                upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
                p = left + up - upleft
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
                paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
                pred = [0 * row, left, up, (left + up) // 2, paeth][ftype]
                raw.append(ftype)
                raw += bytes(((row - pred) % 256).astype(np.uint8))
            png = (b"\x89PNG\r\n\x1a\n"
                   + port_image._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                   + port_image._chunk(b"IDAT", zlib.compress(bytes(raw)))
                   + port_image._chunk(b"IEND", b""))
            np.testing.assert_array_equal(decode_png(png), arr)
            with Image.open(__import__("io").BytesIO(png)) as im:
                np.testing.assert_array_equal(np.atleast_3d(np.array(im)), arr)


def test_unsupported_files_raise(tmp_path):
    """What the port does not read raises. 16-bit and 1-bit PNGs and Adam7
    ones, which it once refused, read as frtm_tpu reads them (every form:
    test_torch_image_formats.py); an Adam7 header over non-interlaced data
    raises on the data's size."""
    rng = np.random.RandomState(5)
    Image.fromarray(rng.randint(0, 65535, (8, 9)).astype(np.uint16)).save(tmp_path / "16.png")
    Image.fromarray(rng.randint(0, 2, (8, 9)).astype(bool)).save(tmp_path / "1bit.png")
    want16 = jax_image.imread(tmp_path / "16.png")
    assert want16.dtype == np.uint16
    np.testing.assert_array_equal(imread(tmp_path / "16.png"), want16)
    got1 = imread(tmp_path / "1bit.png")
    assert (got1.shape, got1.dtype) == ((8, 9, 1), np.uint8)
    with Image.open(tmp_path / "1bit.png") as im:           # PIL: bool
        np.testing.assert_array_equal(got1[..., 0], np.array(im).astype(np.uint8))
    # an interlaced file: the indices of a 4x4 label image, as Adam7 passes
    lb = _labels(rng, 4, 4, n=3)
    rows = b""
    for x0, y0, dx, dy in port_image._ADAM7:       # each row with filter None
        sub = lb[y0::dy, x0::dx]
        rows += b"".join(b"\0" + bytes(r) for r in sub if sub.size)
    png = encode_png_indexed(np.zeros((4, 4), np.uint8), davis_palette)
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 3, 0, 0, 1)
    head = png[:8] + port_image._chunk(b"IHDR", ihdr) + png[8 + 12 + 13:png.index(b"IDAT") - 4]
    interlaced = head + port_image._chunk(b"IDAT", zlib.compress(rows)) + port_image._chunk(
        b"IEND", b"")
    np.testing.assert_array_equal(decode_png(interlaced), lb[..., None])
    (tmp_path / "adam7.png").write_bytes(interlaced)
    np.testing.assert_array_equal(jax_image.imread(tmp_path / "adam7.png"), lb[..., None])
    swapped = png[:8] + port_image._chunk(b"IHDR", ihdr) + png[8 + 12 + 13:]
    with pytest.raises(ValueError, match="bytes of image data"):
        decode_png(swapped)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError):
        decode_png(png[:60])
    (tmp_path / "x.bmp").write_bytes(b"BM")
    with pytest.raises(ValueError, match="unsupported file type"):
        imread(tmp_path / "x.bmp")


def test_jpeg_goes_through_pil_and_says_so_where_it_is_absent(tmp_path, monkeypatch):
    """JPEG once went through PIL and raised where PIL was absent; now the
    port's host library decodes it, equal to the JAX package's reader, and
    nothing changes where PIL cannot be imported."""
    rng = np.random.RandomState(6)
    frames = [rng.randint(0, 256, (48, 64, 3)).astype(np.uint8) for _ in range(3)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(tmp_path / f"{i}.jpg")
        Image.fromarray(f).save(paths[-1], quality=95)
    for p in paths:
        np.testing.assert_array_equal(imread(p), jax_image.imread(p))
    batch = imread_batch(paths)
    assert batch.shape == (3, 48, 64, 3)
    np.testing.assert_array_equal(batch, np.asarray(jax_image.imread_batch(paths)))
    # where PIL is not installed
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(imread(paths[0]), batch[0])
    np.testing.assert_array_equal(imread_batch(paths), batch)
    lb = _labels(rng, 10, 12)
    imwrite_indexed(tmp_path / "lb.png", lb)            # PNG needs no PIL
    np.testing.assert_array_equal(imread(tmp_path / "lb.png")[..., 0], lb)
