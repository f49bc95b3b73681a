"""The port's host library (frtm_tpu_torch/utils/csrc/frtm_host.cpp, built
with the host compiler at first use) against its plain versions and the
libraries it stands in for, with exact equality as the bound throughout:

* Telea inpainting equal on every value to the port's Python Telea
  (`inpaint_telea_plain`) and to cv2.inpaint; the 2x2-ellipse dilation equal
  to cv2.dilate;
* the PNG row unfilter equal to `_unfilter_plain` for each filter type and
  1-4 channels;
* JPEG decoding equal to the JAX package's reader (its own libjpeg build)
  and to PIL on files PIL writes (4:2:0, 4:2:2, 4:4:4, greyscale,
  progressive, restart markers, odd sizes), and so is libjpeg's planar output
  through the chroma upsampling and colour conversion the nvJPEG build
  applies to nvJPEG's planes; the batch decode equal to one file at a time;
  a corrupt file raises;
* two processes building into an empty directory at once both load a whole
  library.
"""
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from frtm_tpu.data import image as jax_image
from frtm_tpu_torch.data import image as port_image
from frtm_tpu_torch.models.inpaint import (dilate_ellipse2, dilate_ellipse2_plain, inpaint_telea,
                                           inpaint_telea_plain)
from frtm_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]


def _telea_cases():
    """(name, image, mask, radius): the cases of tests/test_torch_augmenter.py
    and a hole on the image's border."""
    cases = []
    rng = np.random.RandomState(0)
    blurred = cv2.GaussianBlur((rng.rand(30, 40, 3) * 255).astype(np.uint8), (5, 5), 2)
    for box in [(5, 7, 20, 24), (0, 0, 9, 12), (18, 20, 30, 40)]:
        m = np.zeros((30, 40), np.uint8)
        y0, x0, y1, x1 = box
        m[y0:y1, x0:x1] = 1
        cases.append((f"solid{box}", blurred, m, 1))
    for seed in range(4):
        for radius in (1, 2):
            r = np.random.RandomState(seed)
            img = (r.rand(31, 37, 3) * 255).astype(np.uint8)
            m = (r.rand(31, 37) > 0.75).astype(np.uint8)
            cases.append((f"scattered{seed}r{radius}", img, m, radius))
    # the textured hole of a synthetic frame (test_cut_and_inpaint_matches_jax_augmenter)
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    seq = make_moving_square_sequence(n_frames=1, size=(96, 128), square=24, seed=2)
    mask = dilate_ellipse2_plain((seq.labels[0][..., 0] == 1).astype(np.uint8))
    cases.append(("textured", seq.images[0], mask, 1))
    # a hole along the left and bottom edges, radius 3
    m = np.zeros((30, 40), np.uint8)
    m[12:, :9] = 1
    m[25:, 20:33] = 1
    cases.append(("border", blurred, m, 3))
    return cases


TELEA_CASES = _telea_cases()


@pytest.mark.parametrize("case", TELEA_CASES, ids=[c[0] for c in TELEA_CASES])
def test_telea_equals_plain_and_cv2(case):
    _, img, mask, radius = case
    got = inpaint_telea(img, mask, radius)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, inpaint_telea_plain(img, mask, radius))
    np.testing.assert_array_equal(got, cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA))
    assert not np.array_equal(got, img)


def test_telea_without_a_hole_and_bad_input():
    img = np.arange(5 * 6 * 3, dtype=np.uint8).reshape(5, 6, 3)
    np.testing.assert_array_equal(inpaint_telea(img, np.zeros((5, 6)), 1), img)
    with pytest.raises(ValueError):
        inpaint_telea(img.astype(np.float32), np.zeros((5, 6)), 1)


@pytest.mark.parametrize("width", [23, 1, 16, 17, 854])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dilation_equals_cv2(seed, width):
    """Sparse masks of one value and dense masks of every byte value (the
    library compares 16 unsigned bytes at a time, then the row's tail)."""
    rng = np.random.RandomState(seed)
    sparse = (rng.rand(17 + seed, width) > 0.8).astype(np.uint8) * rng.randint(1, 256)
    dense = rng.randint(0, 256, (9 + seed, width)).astype(np.uint8)
    for m in (sparse, dense):
        want = cv2.dilate(m, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2, 2)))
        np.testing.assert_array_equal(dilate_ellipse2(m), want)
        np.testing.assert_array_equal(dilate_ellipse2_plain(m), want)


def _filtered(arr, ftypes):
    """Raw PNG image data for (h, w, c) uint8 `arr`, row y filtered with
    ftypes[y] (a straightforward encoder)."""
    h, w, c = arr.shape
    flat = arr.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        row, up = flat[y], flat[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), row[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        pred = [0 * row, left, up, (left + up) // 2, paeth][ftypes[y]]
        raw.append(ftypes[y])
        raw += bytes(((row - pred) % 256).astype(np.uint8))
    return bytes(raw)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_png_unfilter_equals_plain(ftype, c):
    rng = np.random.RandomState(c)
    arr = rng.randint(0, 256, (9, 13, c)).astype(np.uint8)
    ftypes = rng.randint(0, 5, 9) if ftype == "mixed" else [ftype] * 9
    raw = _filtered(arr, ftypes)
    got = native.png_unfilter(raw, 9, 13 * c, c)
    np.testing.assert_array_equal(got, port_image._unfilter_plain(raw, 9, 13 * c, c))
    np.testing.assert_array_equal(got.reshape(9, 13, c), arr)


def test_png_unfilter_raises_as_plain():
    raw = bytearray(_filtered(np.zeros((3, 4, 1), np.uint8), [0, 0, 0]))
    raw[5] = 7                                          # row 1's filter byte
    for fn in (native.png_unfilter, port_image._unfilter_plain):
        with pytest.raises(ValueError, match="unknown filter type 7 in row 1"):
            fn(bytes(raw), 3, 4, 1)
        with pytest.raises(ValueError, match="bytes of image data"):
            fn(bytes(raw[:-1]), 3, 4, 1)


def test_decode_png_goes_through_the_library(tmp_path):
    arr = np.random.RandomState(3).randint(0, 256, (21, 17, 3)).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.png")
    np.testing.assert_array_equal(port_image.imread(tmp_path / "a.png"), arr)


def _photo(rng, h, w):
    """Smooth content with some noise: a photograph's spectrum, roughly."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(6 * xx + 2 * c) * np.cos(4 * yy - c) for c in range(3)], -1)
    return np.clip(127 + 100 * base + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)


JPEG_KINDS = {
    "420": dict(quality=90, subsampling="4:2:0"),
    "444": dict(quality=90, subsampling="4:4:4"),
    "422": dict(quality=75, subsampling="4:2:2"),
    "grey": dict(quality=90),
    "progressive": dict(quality=90, progressive=True),
    "restart": dict(quality=85, restart_marker_rows=1),
}


@pytest.mark.parametrize("size", [(48, 64), (97, 131), (17, 5)])
@pytest.mark.parametrize("kind", list(JPEG_KINDS))
def test_jpeg_equals_jax_reader_and_pil(tmp_path, kind, size):
    arr = _photo(np.random.RandomState(size[0]), *size)
    im = Image.fromarray(arr)
    if kind == "grey":
        im = im.convert("L")
    path = tmp_path / f"{kind}.jpg"
    im.save(path, **JPEG_KINDS[kind])
    got = port_image.imread(path)
    assert got.shape == size + (3,) and got.dtype == np.uint8
    with Image.open(path) as pil:
        np.testing.assert_array_equal(got, np.asarray(pil.convert("RGB")))
    want = jax_image.imread(path)
    # the JAX package's reader gives PIL's (H, W, 1) for a grey file where its
    # own library did not build
    np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape))
    np.testing.assert_array_equal(native.decode_jpeg_bytes(path.read_bytes()), got)
    # the nvJPEG build's upsampling and colour conversion, on libjpeg's planes
    np.testing.assert_array_equal(native.decode_jpeg_bytes(path.read_bytes(), planar=True), got)
    assert native.jpeg_dims(path) == size


def test_batch_decode_equals_one_at_a_time(tmp_path):
    rng = np.random.RandomState(9)
    paths = []
    for i in range(7):
        paths.append(tmp_path / f"{i:05d}.jpg")
        Image.fromarray(_photo(rng, 40, 56)).save(paths[-1], quality=80 + i)
    want = np.stack([port_image.imread(p) for p in paths])
    for threads in (1, 3, 0):
        np.testing.assert_array_equal(native.batch_decode_jpeg_files(paths, 40, 56, threads), want)
    np.testing.assert_array_equal(port_image.imread_batch(paths), want)
    np.testing.assert_array_equal(np.asarray(jax_image.imread_batch(paths)), want)
    # a file of another size is named
    Image.fromarray(_photo(rng, 41, 56)).save(tmp_path / "odd.jpg")
    with pytest.raises(ValueError, match="odd.jpg"):
        native.batch_decode_jpeg_files(paths + [tmp_path / "odd.jpg"], 40, 56)
    # mixed sizes fall back to reading one at a time, which cannot stack
    with pytest.raises(ValueError):
        port_image.imread_batch(paths + [tmp_path / "odd.jpg"])


def test_corrupt_jpeg_raises(tmp_path):
    path = tmp_path / "a.jpg"
    Image.fromarray(_photo(np.random.RandomState(1), 64, 80)).save(path, quality=90)
    data = path.read_bytes()
    cases = {"truncated.jpg": data[:len(data) // 2], "garbage.jpg": bytes(range(256)) * 4,
             "header_only.jpg": data[:200], "empty.jpg": b""}
    for name, content in cases.items():
        (tmp_path / name).write_bytes(content)
        with pytest.raises(ValueError, match=name):
            port_image.imread(tmp_path / name)
    with pytest.raises(ValueError, match="truncated.jpg"):
        native.batch_decode_jpeg_files([path, tmp_path / "truncated.jpg"], 64, 80)
    with pytest.raises(FileNotFoundError, match="missing.jpg"):
        native.batch_decode_jpeg_files([tmp_path / "missing.jpg"], 64, 80)


def test_backend_is_named():
    native.library()
    assert native.JPEG_BACKEND.split()[0] in ("libjpeg", "libjpeg-turbo", "nvjpeg")
    assert native.PROBE["backend"] in ("libjpeg", "nvjpeg")
    assert Path(native.PROBE["library"]).parent == native.BUILD_DIR


def test_two_processes_build_an_empty_directory_at_once(tmp_path):
    """Each process builds into the same empty directory under the lock and
    loads what it finds; a half-written library would fail to load."""
    code = ("import sys; from frtm_tpu_torch.utils import native; "
            "lib = native._bind(native.build(sys.argv[1])); "
            "print(native.PROBE['compiled'], lib.frtm_host_jpeg_backend().decode())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "host")], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    compiled = sorted(o.split()[0] for o, _ in outs)
    assert compiled == ["False", "True"], outs          # one compiled, the other waited
    libs = list((tmp_path / "host").glob("libfrtm_host-*.so"))
    assert len(libs) == 1 and not list((tmp_path / "host").glob("*.tmp.so"))


FIXTURES = ROOT / "tests" / "data" / "torch_fixtures"


def _fixture_script():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_jpeg_fixtures", ROOT / "scripts" / "make_torch_jpeg_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_fixtures_decode_to_their_digests():
    """The committed JPEG fixtures decode (libjpeg) to the manifest's sha256 of
    PIL's pixels, and their sources rebuild from the seeded generator to the
    manifest's PSNR (the card's check for a backend other than libjpeg-turbo);
    the all-filters PNG reads to its digest through both unfilters."""
    import hashlib
    import json
    script = _fixture_script()
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    assert len(manifest["jpeg"]) == 21
    for name, entry in manifest["jpeg"].items():
        got = port_image.imread(FIXTURES / name)
        assert list(got.shape) == entry["shape"]
        planar = native.decode_jpeg_bytes((FIXTURES / name).read_bytes(), planar=True)
        np.testing.assert_array_equal(planar, got)
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"], name
        assert script.psnr(got, script.source_of(name)) == pytest.approx(entry["psnr_db"], abs=1e-9)
    (name, entry), = manifest["png"].items()
    got = port_image.imread(FIXTURES / name)
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    assert entry["filters"] == [0, 1, 2, 3, 4] == script._png_filters(FIXTURES / name)
    with Image.open(FIXTURES / name) as im:
        np.testing.assert_array_equal(np.asarray(im), got)
