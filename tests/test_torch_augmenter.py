"""First-frame augmentation without cv2: the port's Telea inpainting against
cv2.inpaint, its 2x2-ellipse dilation against cv2.dilate, its blur against
frtm_tpu's, and the whole augment_first_frame against frtm_tpu's
ImageAugmenter (backend="xla", whose warps use kernel 3's float math) on the
same RandomState, also with the object against each frame edge and corner."""
import cv2
import numpy as np
import pytest
import torch

from frtm_tpu.config import eval_aug_params as jax_aug_params
from frtm_tpu.data.synthetic import make_moving_square_sequence
from frtm_tpu.models.augmenter import ImageAugmenter as JaxAugmenter
from frtm_tpu_torch.config import eval_aug_params
from frtm_tpu_torch.models.augmenter import AugSpec, ImageAugmenter, cut_and_inpaint
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


@pytest.mark.parametrize("blur_size, blur_angle", [(1.0, 0), (2.0, 45), (5.0, 90), (5.0, 135)])
def test_blur_matches_jax(blur_size, blur_angle):
    """The 3x3 and 7x7 blurs of the eval and training sizes, on every value
    (floats, not only their uint8 casts), a flat region included: summed
    in F.conv2d's order, a flat region's values fell a float32 step below
    the integer, and a uint8 count."""
    rng = np.random.RandomState(4)
    img = (rng.rand(40, 52, 3) * 255).astype(np.float32)
    img[5:25, 10:40] = 37.0
    spec = AugSpec((0.5, 0.5), blur_size=blur_size, blur_angle=blur_angle)
    aug = ImageAugmenter(eval_aug_params(3), device="cpu")
    _, G = aug.get_transform(spec, (26, 20, 52, 40), (40, 52))
    jax_aug = JaxAugmenter(jax_aug_params(3), backend="xla")
    want = jax_aug._filter_image(img, G)
    got = aug._filter(torch.from_numpy(img.transpose(2, 0, 1).copy()), G)
    assert G.shape in ((3, 3), (7, 7))
    np.testing.assert_array_equal(got.numpy().transpose(1, 2, 0), want)


# the object's box (y0, y1, x0, x1) on the 96 x 128 frame, for the pastes at
# the frame's edges: an ellipse inscribed in a box that the frame cuts, so
# that the mask meets each edge and corner; rectangles of the whole height
# or width, also against an edge; one-pixel rows and columns on an edge
_PLACES = {
    "top": ("ellipse", (-12, 16, 50, 80)), "bottom": ("ellipse", (80, 108, 50, 80)),
    "left": ("ellipse", (34, 62, -14, 16)), "right": ("ellipse", (34, 62, 112, 142)),
    "top_left": ("ellipse", (-12, 16, -14, 16)), "top_right": ("ellipse", (-12, 16, 112, 142)),
    "bottom_left": ("ellipse", (80, 108, -14, 16)),
    "bottom_right": ("ellipse", (80, 108, 112, 142)),
    "whole_height": ("rect", (0, 96, 50, 78)), "whole_width": ("rect", (36, 64, 0, 128)),
    "whole_height_left": ("rect", (0, 96, 0, 20)),
    "whole_width_bottom": ("rect", (70, 96, 0, 128)),
    "top_row": ("rect", (0, 1, 20, 100)), "right_column": ("rect", (10, 86, 127, 128)),
}


def _placed(place, size=(96, 128), seed=1):
    """A textured object on a textured background, its mask where _PLACES
    puts it: (image (H, W, 3) uint8, mask (H, W, 1) float32)."""
    H, W = size
    rng = np.random.RandomState(seed)
    image = (rng.rand(H, W, 3) * 80 + 40).astype(np.uint8)
    texture = (rng.rand(H, W, 3) * 120 + 120).astype(np.uint8)
    shape, (y0, y1, x0, x1) = _PLACES[place]
    yy, xx = np.mgrid[:H, :W] + 0.5
    if shape == "rect":
        m = (yy > y0) & (yy < y1) & (xx > x0) & (xx < x1)
    else:
        m = (((yy - (y0 + y1) / 2) / ((y1 - y0) / 2)) ** 2
             + ((xx - (x0 + x1) / 2) / ((x1 - x0) / 2)) ** 2) <= 1
    image[m] = texture[m]
    return image, m[..., None].astype(np.float32)


# seed 2 puts the square on the textured hole that showed the Telea fault
@pytest.mark.parametrize("seed, place", [pytest.param(s, None, id=str(s)) for s in (0, 2, 3, 5, 7)]
                         + [pytest.param(1, p, id=p) for p in _PLACES])
def test_augment_first_frame_matches_jax(seed, place):
    if place is None:
        seq = make_moving_square_sequence(n_frames=1, size=(96, 128), square=24, seed=seed)
        image = seq.images[0]
        mask = (seq.labels[0] == 1).astype(np.float32)
        num_aug = 3
    else:
        image, mask = _placed(place, seed=seed)
        num_aug = 8
    rj, rt = np.random.RandomState(0), np.random.RandomState(0)
    jim, jlb = JaxAugmenter(jax_aug_params(num_aug), backend="xla").augment_first_frame(
        image, mask, rj)
    tim, tlb = ImageAugmenter(eval_aug_params(num_aug), device="cpu").augment_first_frame(
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
