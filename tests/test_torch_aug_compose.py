"""The compact augment encoding of the port against frtm_tpu's: the bit
packing, the paste, the composition of the JAX augmenter's CompactAugBatch
on both sides, the port augmenter's compact mode against the JAX one, and
the port's compact batch against its own dense batch.

Bounds (the CompactAugBatch docstring): labels, slot 0, paste rectangles and
unblurred backgrounds bit-exact; a blurred background at most 1 uint8 count
off (the measured shares stand in the tests' docstrings)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.config import eval_aug_params
from frtm_tpu.data.synthetic import make_moving_square_sequence
from frtm_tpu.models import aug_compose as jc
from frtm_tpu.models.augmenter import ImageAugmenter as JaxAugmenter
from frtm_tpu_torch.models.aug_compose import (compose_aug_batch, masked_paste, pack_bits,
                                               pack_compact_batch, unpack_bits)
from frtm_tpu_torch.models.augmenter import CompactAugBatch, ImageAugmenter


def _frame_and_mask(h=96, w=144, sq=28, seed=3):
    rng = np.random.RandomState(seed)
    image = (rng.randint(0, 256, (h, w, 3), np.uint8) // 2 + 64).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    y, x = h // 3, w // 3
    mask[y:y + sq, x:x + sq] = 1
    image[y:y + sq, x:x + sq] = [200, 60, 30]
    return image, mask


def _chw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(2, 0, 1)))


def _compact_from_jax(c) -> CompactAugBatch:
    """The JAX augmenter's CompactAugBatch (numpy, HWC) in the port's layout."""
    return CompactAugBatch(
        image=_chw(c.image), mask=torch.from_numpy(c.mask), inpaint_patch=_chw(c.inpaint_patch),
        inpaint_box=tuple(c.inpaint_box), warp_bases=[_chw(b) for b in c.warp_bases],
        bg_idx=list(c.bg_idx), kernels=list(c.kernels), patches=[_chw(p) for p in c.patches],
        boxes=list(c.boxes), lbl_patches=[torch.from_numpy(np.ascontiguousarray(l))
                                          for l in c.lbl_patches])


@pytest.mark.parametrize("width", [1, 7, 9, 13, 64, 107])
def test_bit_packing_matches_numpy(width):
    rng = np.random.RandomState(width)
    bits = (rng.rand(3, 5, width) > 0.5).astype(np.uint8)
    packed = np.packbits(bits, axis=-1)
    np.testing.assert_array_equal(pack_bits(torch.from_numpy(bits)).numpy(), packed)
    got = unpack_bits(torch.from_numpy(packed), width)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.unpackbits(packed, axis=-1)[..., :width])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.unpack_bits(jnp.asarray(packed),
                                                                          width)))


# (y, x, h, w) on a 20 x 30 frame with 8 x 12 patches: every edge, every
# corner, the interior, a full patch, and empty rectangles
@pytest.mark.parametrize("box", [(0, 0, 8, 12), (0, 18, 8, 12), (12, 0, 8, 12), (12, 18, 8, 12),
                                 (0, 7, 3, 5), (17, 9, 3, 12), (5, 0, 8, 2), (6, 28, 4, 2),
                                 (7, 11, 5, 6), (4, 4, 0, 0), (19, 25, 0, 5), (3, 3, 6, 0)])
def test_masked_paste_matches_jax(box):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    patch = rng.randint(0, 256, (8, 12, 3)).astype(np.uint8)
    want = np.asarray(jc.masked_paste(jnp.asarray(img), jnp.asarray(patch),
                                      jnp.asarray(box, jnp.int32)))
    got = masked_paste(_chw(img).clone(), _chw(patch), box)
    np.testing.assert_array_equal(got.numpy().transpose(1, 2, 0), want)


def _blur_share(got, want, boxes, kinds):
    """Checks the documented bounds slot by slot; returns the largest share
    of values that differ (by 1 count) in a blurred background."""
    share = 0.0
    for k in range(1, got.shape[0]):
        base_idx, blurred = kinds[k - 1]
        diff = np.abs(got[k].astype(np.int32) - want[k].astype(np.int32))
        y, x, h, w = boxes[k - 1]
        assert diff[:, y:y + h, x:x + w].max(initial=0) == 0, f"slot {k}: paste rectangle"
        if not blurred:
            assert diff.max() == 0, f"slot {k}: unblurred background"
        else:
            assert diff.max() <= 1, f"slot {k}: blurred background over 1 count"
            share = max(share, float((diff > 0).mean()))
    return share


def test_compose_matches_jax_on_the_jax_augmenters_batch():
    """Measured: labels and images equal on every value, the blurred
    backgrounds included (the bound allows them 1 count)."""
    image, mask = _frame_and_mask()
    aug = JaxAugmenter(eval_aug_params(8))
    compact = aug.augment_first_frame(image, mask[..., None], np.random.RandomState(0),
                                      compact=True)
    want_im, want_lb = jax.jit(jc.compose_aug_batch)(jnp.asarray(image),
                                                     jc.pack_compact_batch(compact))
    want_im = np.asarray(want_im).transpose(0, 3, 1, 2)
    want_lb = np.asarray(want_lb).transpose(0, 3, 1, 2)
    kinds = [(int(i), k.shape != (1, 1)) for i, k in zip(compact.bg_idx, compact.kernels)]
    assert (0, False) in kinds and any(b for _, b in kinds) and any(i > 0 for i, _ in kinds)

    got_im, got_lb = compose_aug_batch(_chw(image),
                                       pack_compact_batch(_compact_from_jax(compact)))
    assert got_im.dtype == got_lb.dtype == torch.uint8
    np.testing.assert_array_equal(got_lb.numpy(), want_lb)
    np.testing.assert_array_equal(got_im[0].numpy(), want_im[0])
    share = _blur_share(got_im.numpy(), want_im, compact.boxes, kinds)
    assert share == 0.0, share


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_compact_augment_matches_jax(seed):
    """Same spec and accept sequence, same pieces, on every value (the JAX
    augmenter with backend="xla", whose warps use kernel 3's float math; its
    default cv2 warps interpolate in fixed point)."""
    seq = make_moving_square_sequence(n_frames=1, size=(96, 128), square=24, seed=seed)
    image, mask = seq.images[0], (seq.labels[0][..., 0] == 1).astype(np.uint8)
    want = JaxAugmenter(eval_aug_params(6), backend="xla").augment_first_frame(
        image, mask[..., None], np.random.RandomState(0), compact=True)
    got = ImageAugmenter(eval_aug_params(6), "cpu").augment_first_frame(
        image, mask[..., None], np.random.RandomState(0), compact=True)
    assert got.boxes == [tuple(int(v) for v in b) for b in want.boxes]
    assert got.bg_idx == list(want.bg_idx)
    assert tuple(got.inpaint_box) == tuple(want.inpaint_box)
    assert len(got.kernels) == len(want.kernels) == 5
    for a, b in zip(got.kernels, want.kernels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.lbl_patches, want.lbl_patches):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got.patches, want.patches):
        np.testing.assert_array_equal(a.numpy().transpose(1, 2, 0), b)
    for a, b in zip(got.warp_bases, want.warp_bases):
        np.testing.assert_array_equal(a.numpy().transpose(1, 2, 0), b)
    np.testing.assert_array_equal(got.inpaint_patch.numpy().transpose(1, 2, 0),
                                  want.inpaint_patch)
    np.testing.assert_array_equal(got.image.numpy().transpose(1, 2, 0), image)
    np.testing.assert_array_equal(got.mask.numpy(), mask)


def _port_both(num_aug=8, seed=0):
    image, mask = _frame_and_mask()
    aug = ImageAugmenter(eval_aug_params(num_aug), "cpu")
    ims, lbs = aug.augment_first_frame(image, mask[..., None], np.random.RandomState(seed))
    compact = aug.augment_first_frame(image, mask[..., None], np.random.RandomState(seed),
                                      compact=True)
    return image, ims, lbs, compact


def test_port_compact_composes_to_port_dense():
    """Measured: every slot equal but the blurred warped backgrounds, where
    11.8 % of values differ by 1 count (the base's uint8 quantization)."""
    image, ims, lbs, compact = _port_both()
    kinds = [(int(i), k.shape != (1, 1)) for i, k in zip(compact.bg_idx, compact.kernels)]
    assert (0, False) in kinds and (0, True) in kinds and any(i > 0 and b for i, b in kinds)
    got_im, got_lb = compose_aug_batch(_chw(image), pack_compact_batch(compact))
    assert torch.equal(got_lb, lbs)
    assert torch.equal(got_im[0], ims[0])
    for k, (base_idx, blurred) in enumerate(kinds, 1):
        if base_idx == 0:   # the inpainted base holds exact integers
            assert torch.equal(got_im[k], ims[k]), f"slot {k}"
    share = _blur_share(got_im.numpy(), ims.numpy(), compact.boxes, kinds)
    assert 0 < share < 0.35, share


def test_pack_padding_arguments_change_nothing():
    image, ims, lbs, compact = _port_both()
    a = pack_compact_batch(compact)
    ph, pw = a["patches"].shape[-2:]
    b = pack_compact_batch(compact, n_bases=len(compact.warp_bases) + 2,
                           kernel_size=a["kernels"].shape[-1] + 4,
                           patch_bucket=(ph + 9, pw + 17))
    assert b["warp_bases"].shape[0] == a["warp_bases"].shape[0] + 2
    assert b["patches"].shape[-2:] == (ph + 9, pw + 17)
    ia, la = compose_aug_batch(_chw(image), a)
    ib, lb = compose_aug_batch(_chw(image), b)
    assert torch.equal(la, lb)
    assert torch.equal(ia, ib)
    for bad in (dict(n_bases=0), dict(kernel_size=1), dict(kernel_size=8),
                dict(patch_bucket=(1, 1))):
        with pytest.raises(ValueError):
            pack_compact_batch(compact, **bad)
