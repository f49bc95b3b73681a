"""First-frame augmentation without cv2: the port's Telea inpainting against
cv2.inpaint, its 2x2-ellipse dilation against cv2.dilate, and the whole
augment_first_frame against frtm_tpu's ImageAugmenter (backend="xla", whose
warps use kernel 3's float math) on the same RandomState."""
import cv2
import numpy as np
import pytest

from frtm_tpu.config import eval_aug_params as jax_aug_params
from frtm_tpu.data.synthetic import make_moving_square_sequence
from frtm_tpu.models.augmenter import ImageAugmenter as JaxAugmenter
from frtm_tpu_torch.config import eval_aug_params
from frtm_tpu_torch.models.augmenter import ImageAugmenter, cut_and_inpaint
from frtm_tpu_torch.models.inpaint import dilate_ellipse2, inpaint_telea


def test_dilation_matches_cv2(rng):
    m = (rng.rand(17, 23) > 0.8).astype(np.uint8)
    want = cv2.dilate(m, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2, 2)))
    np.testing.assert_array_equal(dilate_ellipse2(m), want)


@pytest.mark.parametrize("box", [(5, 7, 20, 24), (0, 0, 9, 12), (18, 20, 30, 40)])
def test_telea_matches_cv2_on_solid_holes(rng, box):
    """Solid holes (what the augmenter inpaints), inside and touching the
    border: measured identical to cv2 on every hole pixel."""
    img = cv2.GaussianBlur((rng.rand(30, 40, 3) * 255).astype(np.uint8), (5, 5), 2)
    m = np.zeros((30, 40), np.uint8)
    y0, x0, y1, x1 = box
    m[y0:y1, x0:x1] = 1
    want = cv2.inpaint(img, m, 1, cv2.INPAINT_TELEA)
    np.testing.assert_array_equal(inpaint_telea(img, m, 1), want)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_telea_close_to_cv2_on_scattered_holes(seed, radius):
    """Scattered one-pixel holes, the hard case for the level-set weight
    (many small time differences): identical to cv2 on every value. With
    the weight's 1 + |dt| summed in float32 instead of OpenCV's double,
    0.9 % of hole values were 1-2 counts off."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(31, 37, 3) * 255).astype(np.uint8)
    m = (rng.rand(31, 37) > 0.75).astype(np.uint8)
    want = cv2.inpaint(img, m, radius, cv2.INPAINT_TELEA)
    np.testing.assert_array_equal(inpaint_telea(img, m, radius), want)


def test_cut_and_inpaint_matches_jax_augmenter():
    seq = make_moving_square_sequence(n_frames=1, size=(96, 128), square=24, seed=2)
    image, mask = seq.images[0], (seq.labels[0] == 1).astype(np.uint8)
    jt, ji = JaxAugmenter.cut_and_inpaint(image, mask, d=1, f=1)
    tt, ti = cut_and_inpaint(image, mask)
    np.testing.assert_array_equal(tt, jt)
    # the textured hole (4 of 36864 values were 1 count apart before the
    # level-set weight was summed in double, as OpenCV does)
    np.testing.assert_array_equal(ti, ji)


# seed 2 puts the square on the textured hole that showed the Telea fault
@pytest.mark.parametrize("seed", [0, 2, 3, 5, 7])
def test_augment_first_frame_matches_jax(seed):
    seq = make_moving_square_sequence(n_frames=1, size=(96, 128), square=24, seed=seed)
    image = seq.images[0]
    mask = (seq.labels[0] == 1).astype(np.float32)
    rj, rt = np.random.RandomState(0), np.random.RandomState(0)
    jim, jlb = JaxAugmenter(jax_aug_params(3), backend="xla").augment_first_frame(
        image, mask, rj)
    tim, tlb = ImageAugmenter(eval_aug_params(3), device="cpu").augment_first_frame(
        image, mask, rt)
    # same specs drawn and accepted: both generators end in the same state
    assert rj.randint(1 << 30) == rt.randint(1 << 30)
    tim = tim.permute(0, 2, 3, 1).numpy()
    tlb = tlb.permute(0, 2, 3, 1).numpy()
    assert tim.shape == jim.shape and tlb.shape == jlb.shape
    np.testing.assert_array_equal(tlb, jlb)
    # images: equal on every value (the same inverse bits, warp float order
    # and Telea roundings as the JAX augmenter)
    np.testing.assert_array_equal(tim, jim)
    np.testing.assert_array_equal(tim[0], image)
