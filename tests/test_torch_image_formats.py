"""The port's image I/O on every PNG that frtm_tpu reads and on the JPEG that
frtm_tpu writes (frtm_tpu_torch/data/image.py, the host library's
png_samples and encode_jpeg), held against frtm_tpu.data.image with exact
equality as the bound throughout:

* every colour type at every bit depth the PNG format allows, non-interlaced
  and Adam7, at odd and even widths (sub-byte rows end in padding bits), all
  five row filters: the port's imread gives frtm_tpu's imread's shape, dtype
  and values. For grey at 1, 2 and 4 bits frtm_tpu's answer depends on its
  host library: libpng hands it the raw samples, its PIL fallback scales
  them (0 / 85 / 170 / 255) or gives bool at 1 bit. The port follows libpng,
  so those cases are held against frtm_tpu's libpng reader where its library
  loaded and against PIL's samples unscaled where it did not;
* the host library's sample unpacking and de-interlacing equal to
  `png_samples_plain` on every value, and its errors where the plain
  version's are;
* JPEG: the port's imwrite writes the bytes frtm_tpu's imwrite writes (PIL
  at its defaults, libjpeg-turbo's islow path) at 1x1, 7x9, 37x53 and
  480x854, smooth and noise, (H, W, 3), (H, W) and (H, W, 1), and where
  `squeeze` changes the shape; the C++ encoder's bytes equal
  `encode_jpeg_plain`'s, and PIL's where the image ends inside a 16x16
  block group; two and four channels, and bool samples in colour, raise as
  PIL does;
* the committed fixtures (scripts/make_torch_jpeg_fixtures.py): the port
  writes each imwrite/ JPEG's bytes from its rebuilt source and reads each
  png_forms/ and davis_2bit/ PNG to the manifest's digest of frtm_tpu's
  pixels.
"""
import hashlib
import importlib.util
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from frtm_tpu.data import image as jax_image
from frtm_tpu.utils import native as jax_native
from frtm_tpu_torch.data import image as port_image
from frtm_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "torch_fixtures"


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_jpeg_fixtures", ROOT / "scripts" / "make_torch_jpeg_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _fixture_script()
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
# (colour type, bit depth) pairs the PNG format allows
PNG_PAIRS = [(ctype, depth) for ctype, (_, _, depths) in SCRIPT.PNG_FORMS.items()
             for depth in depths]


def _samples(rng, ctype, depth, h, w):
    c = SCRIPT.PNG_FORMS[ctype][1]
    top = min(1 << depth, 256) if ctype == 3 else 1 << depth
    return rng.randint(0, top, (h, w, c)).astype(np.uint16 if depth == 16 else np.uint8)


def _png(rng, ctype, depth, interlace, h, w):
    samples = _samples(rng, ctype, depth, h, w)
    palette = rng.randint(0, 256, (1 << min(depth, 8), 3)) if ctype == 3 else None
    return samples, SCRIPT.encode_png_samples(samples, depth, ctype, interlace, palette=palette)


def _jax_reads(path, ctype, depth):
    """frtm_tpu's imread of a PNG; for grey under 8 bits its libpng reader's
    answer where its library loaded, else PIL's samples unscaled."""
    if ctype == 0 and depth < 8:
        if jax_native.available():
            return jax_native.read_png_index(path)[..., None]
        with Image.open(path) as im:
            pil = np.array(im)
        return (pil.astype(np.uint8) if depth == 1 else pil // (255 // ((1 << depth) - 1)))[
            ..., None]
    return jax_image.imread(path)


@pytest.mark.parametrize("width", [53, 56])
@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype, depth", PNG_PAIRS)
def test_reads_every_png_form_as_frtm_tpu(tmp_path, ctype, depth, interlace, width):
    rng = np.random.RandomState(ctype * 100 + depth * 10 + interlace)
    samples, data = _png(rng, ctype, depth, interlace, 11, width)
    path = tmp_path / "a.png"
    path.write_bytes(data)
    want = _jax_reads(path, ctype, depth)
    got = port_image.imread(path)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, SCRIPT.png_form_pixels(ctype, depth, samples))


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (9, 9), (16, 17)])
@pytest.mark.parametrize("ctype, depth", PNG_PAIRS)
def test_png_samples_equal_plain(ctype, depth, size):
    """Both interlace methods, sizes where Adam7 passes are empty (1x1, 2x3)
    or cut short."""
    rng = np.random.RandomState(depth)
    c = SCRIPT.PNG_FORMS[ctype][1]
    for interlace in (0, 1):
        samples, data = _png(rng, ctype, depth, interlace, *size)
        # the IDAT chunk's inflated bytes (the palette chunk sits before it)
        idat = data.index(b"IDAT")
        n = int.from_bytes(data[idat - 4:idat], "big")
        raw = zlib.decompress(data[idat + 4:idat + 4 + n])
        got = native.png_samples(raw, *size, depth, c, interlace)
        want = port_image.png_samples_plain(raw, *size, depth, c, interlace)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, samples)


def test_png_samples_raise_as_plain():
    rng = np.random.RandomState(1)
    samples = _samples(rng, 0, 2, 9, 9)
    raw = bytearray(zlib.decompress(
        SCRIPT.encode_png_samples(samples, 2, 0, 1, ftypes=(0,))[41:-16]))
    raw[2] = 9              # pass 1 is two rows of 1 + 1 bytes: its second row's filter
    raw[4] = 7              # pass 2's first row (the first bad one counts)
    for fn in (native.png_samples, port_image.png_samples_plain):
        with pytest.raises(ValueError, match="unknown filter type 9 at byte 2 of"):
            fn(bytes(raw), 9, 9, 2, 1, 1)
        with pytest.raises(ValueError, match="bytes of image data"):
            fn(bytes(raw[:-1]), 9, 9, 2, 1, 1)
        with pytest.raises(ValueError, match="bytes of image data"):
            fn(bytes(raw), 9, 9, 2, 1, 0)      # Adam7 data read as one image
        # 2^28 grey samples at 16 bits: a row of 2^32 bits, which must not
        # wrap to a row of 0 bytes that one byte of image data would fill
        with pytest.raises(ValueError, match="bytes of image data"):
            fn(b"\0", 1, 2 ** 28, 16, 1, 0)


def test_png_samples_row_length_does_not_wrap():
    """The host library itself refuses the 2^32-bit row, and decode_png
    refuses a file that declares it, and sizes the format does not allow."""
    raw, out = np.zeros(1, np.uint8), np.zeros(8, np.uint8)
    assert native.library().png_samples(native._u8(raw), 1, 1, 2 ** 28, 16, 1, 0,
                                        native._u8(out)) == -1
    for w, h, match in ((2 ** 28, 1, "bytes of image data"), (0, 3, "outside"),
                        (2 ** 31, 1, "outside")):
        data = (b"\x89PNG\r\n\x1a\n"
                + SCRIPT._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
                + SCRIPT._png_chunk(b"IDAT", zlib.compress(b"\0"))
                + SCRIPT._png_chunk(b"IEND", b""))
        with pytest.raises(ValueError, match=match):
            port_image.decode_png(data)


def test_decode_png_refuses_what_the_format_does_not_allow():
    data = SCRIPT.encode_png_samples(np.zeros((3, 4, 3), np.uint8), 8, 2)
    for depth, ctype in ((4, 2), (16, 3), (2, 6), (8, 5)):
        ihdr = data[12:29].replace(bytes([8, 2]), bytes([depth, ctype]), 1)
        bad = data[:8] + SCRIPT._png_chunk(b"IHDR", ihdr[4:]) + data[33:]
        with pytest.raises(ValueError, match="bit depth|colour type"):
            port_image.decode_png(bad)


def _content(kind, shape, seed):
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, shape).astype(np.uint8)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    c = shape[2] if len(shape) == 3 else 1
    base = [128 + 90 * np.sin(xx / (7 + 3 * k) + yy / 11) * np.cos(yy / (13 + k)) for k in range(c)]
    im = np.stack(base, -1) + rng.randn(shape[0], shape[1], c)
    return np.clip(np.rint(im), 0, 255).astype(np.uint8).reshape(shape)


def _jax_jpeg(tmp_path, im):
    jax_image.imwrite(tmp_path / "jax.jpg", im)
    return (tmp_path / "jax.jpg").read_bytes()


@pytest.mark.parametrize("layout", ["rgb", "hw", "hw1"])
@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (37, 53), (480, 854)])
def test_jpeg_bytes_equal_frtm_tpu(tmp_path, size, kind, layout):
    shape = size + {"rgb": (3,), "hw": (), "hw1": (1,)}[layout]
    im = _content(kind, shape, seed=sum(size))
    if im.size == 1 and layout != "rgb":        # squeezed to a scalar: neither writes it
        with pytest.raises(IndexError):
            _jax_jpeg(tmp_path, im)
        with pytest.raises(ValueError, match="JPEG: a single value"):
            port_image.imwrite(tmp_path / "port.jpg", im)
        return
    port_image.imwrite(tmp_path / "port.jpg", im)
    assert (tmp_path / "port.jpg").read_bytes() == _jax_jpeg(tmp_path, im)


@pytest.mark.parametrize("name, im", [
    ("one row of colour", np.arange(15, dtype=np.uint8).reshape(1, 5, 3) * 17),
    ("one column", np.arange(33, dtype=np.uint8).reshape(33, 1, 1) * 7),
    ("a vector", np.arange(6, dtype=np.uint8) * 40),
    ("bool", np.eye(9, 7, dtype=bool)),
    (".JPEG", np.full((5, 6, 3), 200, np.uint8))])
def test_jpeg_keeps_squeeze_s_meaning(tmp_path, name, im):
    """frtm_tpu hands PIL np.asarray(im).squeeze(): (1, 5, 3) is a 5x3 grey
    image, a vector N rows of one column, bool 0 / 255; the suffix in any case."""
    suffix = ".JPEG" if name == ".JPEG" else ".jpg"
    port_image.imwrite(tmp_path / f"port{suffix}", im)
    jax_image.imwrite(tmp_path / f"jax{suffix}", im)
    assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()


@pytest.mark.parametrize("layout", ["rgb", "hw"])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (8, 16), (17, 33), (37, 53)])
def test_jpeg_encoder_equals_plain(size, layout):
    im = _content("noise", size + ((3,) if layout == "rgb" else ()), seed=size[0])
    assert native.encode_jpeg(im) == port_image.encode_jpeg_plain(im)
    smooth = _content("smooth", im.shape, seed=size[1])
    assert native.encode_jpeg(smooth) == port_image.encode_jpeg_plain(smooth)


@pytest.mark.parametrize("size", [(15, 16), (16, 15), (16, 17), (17, 16), (9, 24), (24, 9)])
def test_jpeg_encoder_as_pil_at_mcu_edges(size):
    """Colour images one pixel short of or past a 16x16 MCU, or a block row
    or column into one: the edge replication and the dummy Y blocks give
    PIL's file at its defaults."""
    im = _content("smooth", size + (3,), seed=size[0] * size[1])
    buf = io.BytesIO()
    Image.fromarray(im).save(buf, format="JPEG")
    assert native.encode_jpeg(im) == buf.getvalue()


@pytest.mark.parametrize("shape, dtype, message", [
    ((6, 7, 2), np.uint8, "cannot write mode LA as JPEG"),
    ((6, 7, 4), np.uint8, "cannot write mode RGBA as JPEG"),
    ((1, 1), np.uint8, None), ((4, 5), np.float32, "cannot write mode F as JPEG"),
    ((4, 5, 3), bool, "Cannot handle this data type")])
def test_jpeg_raises_where_frtm_tpu_does(tmp_path, shape, dtype, message):
    im = np.zeros(shape, dtype)
    with pytest.raises(Exception) as jax_err:
        jax_image.imwrite(tmp_path / "jax.jpg", im)
    if message is not None:
        assert message in str(jax_err.value)
    with pytest.raises((ValueError, TypeError), match="JPEG"):
        port_image.imwrite(tmp_path / "port.jpg", im)
    assert not (tmp_path / "port.jpg").exists()


@pytest.mark.parametrize("name", sorted(MANIFEST["imwrite"]))
def test_committed_imwrite_jpegs(tmp_path, name):
    """The port writes each committed frtm_tpu JPEG's bytes from the rebuilt
    source; both encoders agree; the file decodes to the manifest's pixels."""
    entry = MANIFEST["imwrite"][name]
    src = SCRIPT.imwrite_source(name)
    port_image.imwrite(tmp_path / "port.jpg", src)
    data = (tmp_path / "port.jpg").read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256_file"]
    assert data == (FIXTURES / name).read_bytes()
    assert port_image.encode_jpeg_plain(src) == data
    with Image.open(FIXTURES / name) as im:
        dec = np.asarray(im.convert("RGB"))
    assert hashlib.sha256(dec.tobytes()).hexdigest() == entry["sha256"]


@pytest.mark.parametrize("name", sorted(MANIFEST["png_forms"]) + sorted(MANIFEST["davis_2bit"]))
def test_committed_pngs_read_to_frtm_tpu_s_digest(name):
    entry = MANIFEST["png_forms"].get(name) or MANIFEST["davis_2bit"][name]
    data = (FIXTURES / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256_file"]
    got = port_image.imread(FIXTURES / name)
    assert [list(got.shape), str(got.dtype)] == [entry["shape"], entry.get("dtype", "uint8")]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    if name.startswith("davis_2bit/"):      # the 8-bit annotation's labels
        eight = FIXTURES / "davis" / Path(name).relative_to("davis_2bit")
        np.testing.assert_array_equal(got, port_image.imread(eight))
    else:
        np.testing.assert_array_equal(got, _jax_reads(FIXTURES / name, entry["colour_type"],
                                                      entry["bit_depth"]))
