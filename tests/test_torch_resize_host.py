"""The port's cv2-free resizers (data/resize_host.py) against cv2.resize on
the shapes the training loaders meet, and the host library's C++ against the
plain numpy versions. Nearest and area are bit-equal to cv2; cubic is held to
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
    # cv2 takes other area paths where an axis enlarges or both factors are
    # whole numbers; the port raises there rather than differ quietly
    for fn in (R.resize_area, R.resize_area_plain):
        with pytest.raises(NotImplementedError):
            fn(im, (60, 60))
        with pytest.raises(NotImplementedError):
            fn(im, (24, 32))
    with pytest.raises(ValueError):
        R.resize_area(im.astype(np.float32), (24, 30))
