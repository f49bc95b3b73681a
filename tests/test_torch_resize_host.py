"""The port's cv2-free resizers (data/resize_host.py) against cv2.resize on
the shapes the training loaders meet, and the host library's C++ against the
plain numpy versions. Nearest and area (all three of OpenCV's INTER_AREA
paths) are bit-equal to cv2; cubic is held to
one grey level, with the share of unequal values bounded (OpenCV's uint8
cubic sums in a fixed point the port does not reproduce; measured 0.04-0.12 %
of values on random images)."""
import cv2
import numpy as np
import pytest

from frtm_tpu_torch.data import resize_host as R

# (source, destination): YouTube-VOS 720p and 1080p frames and a DAVIS
# full-resolution frame shrink to 480x854; a frame 500x900; small odd shapes
AREA = [((720, 1280), (480, 854)), ((1080, 1920), (480, 854)), ((500, 900), (480, 854)),
        ((37, 53), (20, 31)), ((480, 900), (480, 854))]
# frames under 480 rows enlarge (cubic); the labels of every case (nearest)
CUBIC = [((360, 640), (480, 854)), ((240, 427), (480, 854)), ((300, 500), (480, 854)),
         ((720, 1280), (480, 854)), ((37, 53), (20, 31))]


def _image(rng, shape, channels=3):
    # texture with smooth and sharp parts, like a frame
    base = cv2.resize((rng.rand(8, 8, channels) * 255).astype(np.uint8), shape[::-1],
                      interpolation=cv2.INTER_LINEAR).reshape(*shape, channels)
    noise = rng.randint(-40, 41, base.shape)
    return np.clip(base.astype(np.int64) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("src,dst", AREA)
def test_area_equals_cv2(rng, src, dst):
    im = _image(rng, src)
    want = cv2.resize(im, dst[::-1], interpolation=cv2.INTER_AREA)
    plain = R.resize_area_plain(im, dst)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(R.resize_area(im, dst), plain)
    grey = im[..., 0].copy()
    np.testing.assert_array_equal(R.resize_area(grey, dst),
                                  cv2.resize(grey, dst[::-1], interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("src,dst", CUBIC)
def test_cubic_within_one_level_of_cv2(rng, src, dst):
    im = _image(rng, src)
    want = cv2.resize(im, dst[::-1], interpolation=cv2.INTER_CUBIC).astype(np.int64)
    plain = R.resize_cubic_plain(im, dst)
    np.testing.assert_array_equal(R.resize_cubic(im, dst), plain)
    gap = np.abs(plain.astype(np.int64) - want)
    assert gap.max() <= 1
    assert gap.mean() < 5e-3, gap.mean()


@pytest.mark.parametrize("src,dst", CUBIC + AREA)
def test_nearest_labels_equal_cv2(rng, src, dst):
    lb = (rng.rand(*src) > 0.7).astype(np.uint8)
    want = cv2.resize(lb, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(R.resize_nearest_plain(lb, dst), want)
    np.testing.assert_array_equal(R.resize_nearest(lb, dst), want)


def test_equal_sizes_copy_and_unported_paths_raise(rng):
    im = _image(rng, (48, 64))
    for fn in (R.resize_area, R.resize_cubic, R.resize_nearest, R.resize_area_plain,
               R.resize_cubic_plain, R.resize_nearest_plain):
        out = fn(im, (48, 64))
        np.testing.assert_array_equal(out, im)
        assert out is not im and not np.shares_memory(out, im)
    # cv2's two other area paths, where an axis enlarges and where both
    # factors are whole numbers, raised before they were ported; now both
    # give cv2's values (the tests below cover them)
    for fn in (R.resize_area, R.resize_area_plain):
        for size in ((60, 60), (24, 32)):
            np.testing.assert_array_equal(fn(im, size), cv2.resize(im, size[::-1],
                                                                   interpolation=cv2.INTER_AREA))
    with pytest.raises(ValueError):
        R.resize_area(im.astype(np.float32), (24, 30))


# (source, destination) of OpenCV's resizeAreaFast (both factors whole): 2 and
# 3 on both axes, 1 on one, 2x2 at the loaders' 960x1708
AREA_FAST = [((96, 128), (48, 64)), ((99, 129), (33, 43)), ((90, 120), (90, 40)),
             ((90, 120), (45, 40)), ((960, 1708), (480, 854))]
# where an axis enlarges: both (DAVIS frames under 480x854), or one up and
# one down in either order
AREA_ENLARGE = [((48, 64), (96, 128)), ((240, 427), (480, 854)), ((300, 500), (480, 854)),
                ((37, 53), (120, 121)), ((37, 53), (20, 121)), ((37, 53), (120, 31)),
                ((500, 900), (480, 1708))]


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("src,dst", AREA_FAST + AREA_ENLARGE)
def test_other_area_paths_equal_cv2(rng, src, dst, channels):
    """OpenCV's resizeAreaFast and its linear path with area weights: the
    plain version equal to cv2.resize(INTER_AREA) on every value, the C++
    equal to the plain version; 2-D images too."""
    path = R.area_path(src, dst)[0]
    assert path == ("fast" if (src, dst) in AREA_FAST else "linear")
    im = _image(rng, src, channels)
    want = cv2.resize(im, dst[::-1], interpolation=cv2.INTER_AREA).reshape(*dst, channels)
    plain = R.resize_area_plain(im, dst)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(R.resize_area(im, dst), plain)
    if channels == 1:
        grey = im[..., 0].copy()
        np.testing.assert_array_equal(R.resize_area(grey, dst), want[..., 0])
        np.testing.assert_array_equal(R.resize_area_plain(grey, dst), want[..., 0])
