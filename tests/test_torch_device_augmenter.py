"""The port's DeviceAugmenter (models/device_augmenter.py) against frtm_tpu's
on the CPU, on the same frames, masks and RandomState.

What must be equal, and is: every retry round's visibility counts (hence the
same accepted specs), the labels, the crop each round warps. The images may
differ where a blurred value lands within rounding of an integer: the port
blurs as k^2 shifted multiply-adds, XLA in its convolution's order, and the
`floor` of the paste then puts the two one grey level apart. Bound: at most
one grey level, on under 0.1 % of the values; measured at most 1, on 0 to
5.4e-5 of the values (2 of 147,456 in the JAX test's scene, 35 of 648,000
in the 20-frame case, none in the third).

Also: the batched and mixed plain warps (ops/warp.py) against the one-map,
one-mode warp, bit for bit; `_embed_kernel`, `_kernel_max` and the crop box;
the three errors; and the launch-count rule, on the CPU as the count of
aten operators: one round costs the same at 4 specs and at 19.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import frtm_tpu.models.device_augmenter as jda
from frtm_tpu.config import eval_aug_params as jax_aug_params
from frtm_tpu.models.augmenter import center_bbox_from_mask as jax_bbox
from frtm_tpu_torch.config import eval_aug_params
from frtm_tpu_torch.models import device_augmenter as tda
from frtm_tpu_torch.ops.kernels import warp_affine, warp_affine_batched
from frtm_tpu_torch.ops.warp import (inverse_coefficients, warp_affine_batched_plain,
                                     warp_affine_plain)

torch.set_num_threads(2)


def _scene(rng, H=96, W=128, sq=28, y=30, x=40):
    """tests/test_device_augmenter.py's scene, the square placed at (y, x)."""
    im = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    mask = np.zeros((H, W, 1), np.float32)
    mask[y:y + sq, x:x + sq] = 1
    im[y:y + sq, x:x + sq] = (rng.rand(sq, sq, 3) * 120 + 120).astype(np.uint8)
    return im, mask


class _Rounds:
    """Records what each retry round of an augmenter computed: its counts
    and the shape of the crop it warped."""

    def __init__(self, monkeypatch, module, name, to_numpy):
        self.counts, self.crops = [], []
        inner = getattr(module, name)

        def spy(inpainted, target_crop, *args, **kw):
            out = inner(inpainted, target_crop, *args, **kw)
            self.counts.append(to_numpy(out[2]).astype(np.int64).tolist())
            self.crops.append(tuple(np.shape(target_crop)))
            return out
        monkeypatch.setattr(module, name, spy)


def _both(monkeypatch, im, mask, params, seed=0):
    """(JAX images, labels, rounds), (port images, labels, rounds), all
    numpy in (K, H, W, C)."""
    jr = _Rounds(monkeypatch, jda, "_batch_augment", np.asarray)
    tr = _Rounds(monkeypatch, tda, "batch_augment", lambda t: t.numpy())
    ji, jl = jda.DeviceAugmenter(params).augment_first_frame(im, mask,
                                                             np.random.RandomState(seed))
    ti, tl = tda.DeviceAugmenter(params, "cpu").augment_first_frame(
        im, mask, np.random.RandomState(seed))
    assert ti.dtype == tl.dtype == torch.uint8
    return ((np.asarray(ji), np.asarray(jl), jr),
            (ti.numpy().transpose(0, 2, 3, 1), tl.numpy().transpose(0, 2, 3, 1), tr))


# (scene, num_aug, min_px_count): the JAX test's scene at 96x128 and two more
# sizes and seeds (objects on the right and left frame edges), one of them
# with a visibility floor that rejects specs and takes a second round
_CASES = {
    "jax_scene": (dict(), 4, None),
    "right_edge": (dict(H=80, W=150, sq=20, y=0, x=130), 5, None),
    "left_edge_rejects": (dict(H=120, W=90, sq=40, y=70, x=0), 20, 1200),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_device_augmenter_matches_jax(monkeypatch, case):
    kw, num_aug, min_px = _CASES[case]
    im, mask = _scene(np.random.RandomState(sorted(_CASES).index(case)), **kw)
    params = eval_aug_params(num_aug)
    jparams = jax_aug_params(num_aug)
    if min_px is not None:
        params["min_px_count"] = jparams["min_px_count"] = min_px
    (ji, jl, jr), (ti, tl, tr) = _both(monkeypatch, im, mask, params)
    assert ti.shape == ji.shape == (num_aug,) + im.shape
    assert tl.shape == jl.shape == (num_aug,) + im.shape[:2] + (1,)
    # the same rounds, counts and crops: the same accepted specs
    assert tr.counts == jr.counts and tr.crops == [(c[2], c[0], c[1]) for c in jr.crops]
    if case == "left_edge_rejects":
        assert len(tr.counts) >= 2 and min(min(c) for c in tr.counts) < min_px
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(ti[0], im)
    diff = np.abs(ti.astype(np.float32) - ji)
    assert diff.max() <= 1.0, diff.max()
    assert float((diff > 0).mean()) < 1e-3, float((diff > 0).mean())


def test_embed_kernel_and_kernel_max():
    g = np.random.RandomState(0)
    for k, kmax in ((1, 1), (1, 7), (3, 7), (5, 5), (7, 7), (3, 9)):
        G = g.rand(k, k).astype(np.float32)
        np.testing.assert_array_equal(tda._embed_kernel(G, kmax), jda._embed_kernel(G, kmax))
    for fg, bg in (([0.0, 2.0], [0.0, 1.0, 2.0, 5.0]), ([0.0], None), ([0.0, 9.0], [3.0]),
                   ([0.0, 4.0], [0.0])):
        p = eval_aug_params(5)
        p["fg_aug_params"] = dict(p["fg_aug_params"], blur_size=fg)
        if bg is None:
            p.pop("bg_aug_params")
        else:
            p["bg_aug_params"] = dict(p["bg_aug_params"], blur_size=bg)
        want = jda.DeviceAugmenter(p)._kernel_max()
        assert tda.DeviceAugmenter(p, "cpu")._kernel_max() == want
        assert want % 2 == 1
    # the eval selections' largest blur (5.0): a 7x7 canvas
    assert tda.DeviceAugmenter(eval_aug_params(5), "cpu")._kernel_max() == 7


@pytest.mark.parametrize("where", ["top_left", "bottom_right", "wide", "whole_height"])
def test_crop_bucket_at_frame_edges(monkeypatch, where):
    """The bucketed crop, clipped at each frame edge, is the one frtm_tpu
    warps (and the labels and counts follow it)."""
    H, W = 70, 100
    box = {"top_left": (0, 0, 20, 30), "bottom_right": (52, 75, 18, 25),
           "wide": (30, 2, 10, 96), "whole_height": (0, 40, 70, 12)}[where]
    y, x, h, w = box
    rng = np.random.RandomState(5)
    im = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    mask = np.zeros((H, W, 1), np.float32)
    mask[y:y + h, x:x + w] = 1
    x0, y0, cw, ch = tda.crop_box(jax_bbox(mask), (H, W), 64)
    assert x0 + cw <= W and y0 + ch <= H and x0 >= 0 and y0 >= 0
    assert x0 <= x and y0 <= y and x + w <= x0 + cw and y + h <= y0 + ch
    (ji, jl, jr), (ti, tl, tr) = _both(monkeypatch, im, mask, eval_aug_params(4))
    assert tr.crops[0] == (4, ch, cw) and jr.crops[0] == (ch, cw, 4)
    assert tr.counts == jr.counts
    np.testing.assert_array_equal(tl, jl)


def test_errors_match_jax():
    im, mask = _scene(np.random.RandomState(0))
    for aug in (jda.DeviceAugmenter, lambda p: tda.DeviceAugmenter(p, "cpu")):
        p = eval_aug_params(4)
        p["min_px_count"] = int(mask.sum()) + 1
        with pytest.raises(ValueError, match="too small"):
            aug(p).augment_first_frame(im, mask, np.random.RandomState(0))
        p = eval_aug_params(4)
        p["min_px_count"] = 0
        with pytest.raises(ValueError, match="No object"):
            aug(p).augment_first_frame(im, np.zeros_like(mask), np.random.RandomState(0))
        # every spec shrinks the object under the visibility floor
        p = eval_aug_params(4)
        p["min_px_count"] = int(mask.sum())
        p["fg_aug_params"] = dict(p["fg_aug_params"], scale=[0.5])
        a = aug(p)
        a.max_retries = 2
        with pytest.raises(RuntimeError, match="after 2 retries"):
            a.augment_first_frame(im, mask, np.random.RandomState(0))


def _maps(rng, n, projective=False):
    Ms = []
    for _ in range(n):
        a, s = rng.uniform(-1, 1), rng.uniform(0.5, 2)
        Ms.append(np.array([[s * np.cos(a), s * np.sin(a), rng.uniform(-20, 20)],
                            [-s * np.sin(a), s * np.cos(a), rng.uniform(-20, 20)], [0, 0, 1]]))
    if projective:
        Ms.append(np.array([[1.0, 0.1, 2.0], [0.05, 0.9, -1.0], [1e-3, -2e-3, 1.0]]))
    return Ms


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("nearest_from", [None, 4, 1])
def test_batched_and_mixed_plain_warps_are_bit_equal(mode, nearest_from):
    """Each map's output of the batched / mixed plain warp (and of the
    wrappers on a CPU tensor) is warp_affine_plain of its map and its
    planes' mode, bit for bit."""
    rng = np.random.RandomState(1)
    src = torch.from_numpy((rng.rand(5, 40, 52) * 255).astype(np.float32))
    src[4] = (src[4] > 128).float()
    Ms = _maps(rng, 7, projective=True)
    hinvs = np.stack([inverse_coefficients(M) for M in Ms])
    got = warp_affine_batched_plain(src, hinvs, (33, 47), mode, nearest_from)
    assert got.shape == (len(Ms), 5, 33, 47)
    k = 5 if nearest_from is None else nearest_from
    for i, h in enumerate(hinvs):
        assert torch.equal(got[i, :k], warp_affine_plain(src[:k], h, (33, 47), mode)), i
        assert torch.equal(got[i, k:], warp_affine_plain(src[k:], h, (33, 47), "nearest")), i
        assert torch.equal(warp_affine(src, Ms[i], (33, 47), mode, nearest_from), got[i])
    assert torch.equal(warp_affine_batched(src, Ms, (33, 47), mode, nearest_from), got)
    lbl = src[4:].to(torch.uint8)
    assert torch.equal(warp_affine_batched(lbl, Ms, (33, 47), "nearest"),
                       warp_affine_batched_plain(src[4:], hinvs, (33, 47),
                                                 "nearest").to(torch.uint8))


def _aten_ops(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(e.name for e in prof.events() if e.name.startswith("aten::"))


def test_round_op_count_does_not_grow_with_specs():
    """generate_specs takes `num_aug` from the selections (19 specs by
    default): one round of 4 specs and one of 19 make the same aten
    operators, so on the card the same launches."""
    im, mask = _scene(np.random.RandomState(0))
    ops, specs = {}, {}
    for n in (5, 20):
        p = eval_aug_params(4)
        p["fg_aug_params"] = dict(p["fg_aug_params"], num_aug=n)
        p["bg_aug_params"] = dict(p["bg_aug_params"], num_aug=n)
        aug = tda.DeviceAugmenter(p, "cpu")
        specs[n] = len(aug.host.generate_specs(p["fg_aug_params"], np.random.RandomState(0)))
        ops[n] = _aten_ops(lambda: aug.augment_first_frame(im, mask, np.random.RandomState(0)))
        assert aug.last_rounds == 1
    assert specs == {5: 4, 20: 19}
    assert len(ops[5]) == len(ops[20]) and ops[5] == ops[20], (len(ops[5]), len(ops[20]))
    assert ops[5].count("aten::addcmul_") == 2 * 7 * 7
