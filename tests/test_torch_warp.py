"""The port's warp inverse against JAX's, bit for bit, and the host planner
of kernel 3's two variants.

`inverse_coefficients` repeats, in float32, the roundings of
`jnp.linalg.inv` on the CPU (LAPACK sgetrf and two strsm), so the port's
warp maps every output pixel to the same source coordinates as frtm_tpu's.
`plan_warp` sends every affine warp of the augmenter to the staged kernel;
the box it plans must hold each tile's source box (`tile_boxes`, the
kernel's arithmetic), which must hold every tap.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frtm_tpu.ops.warp import warp_affine as jax_warp
from frtm_tpu_torch.config import eval_aug_params
from frtm_tpu_torch.models.augmenter import AugSpec, ImageAugmenter
from frtm_tpu_torch.ops.kernels.warp_affine import STAGED_SMEM_BYTES, STAGED_TILE, plan_warp
from frtm_tpu_torch.ops.warp import _inverse_map, inverse_coefficients, warp_affine_plain

_jinv = jax.jit(jnp.linalg.inv)

# chip_smoke.py's background warp: rotation 0.3 rad, scale 1.2, shift
T_SMOKE = np.array([[1.2 * np.cos(0.3), 1.2 * np.sin(0.3), -60.0],
                    [-1.2 * np.sin(0.3), 1.2 * np.cos(0.3), 90.0], [0, 0, 1]])


def augmenter_like(n, seed, hw=(480, 854), projective=True):
    """Seeded forward maps as ImageAugmenter.get_transform builds them
    (translate @ skew @ rotate @ scale/mirror @ translate) at hw; every third
    is shifted to a paste sub-box, every third made mildly projective (or,
    with projective=False, left affine)."""
    rng = np.random.default_rng(seed)
    (h, w), f = hw, hw[0] / 480
    out = []
    for i in range(n):
        a = np.deg2rad(rng.choice([5, -5, 10, -10, 20, -20, 30, -30, 45, -45, 60, -60]))
        s = rng.choice([0.7, 1.0, 1.5, 2.0]) * rng.uniform(0.5, 2.0)
        k = rng.choice([0.0, 0.1])
        T = (np.array([[1, 0, rng.uniform(0, w)], [0, 1, rng.uniform(0, h)], [0, 0, 1]])
             @ np.array([[1, k, 0], [k, 1, 0], [0, 0, 1]])
             @ np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]])
             @ np.diag([rng.choice([1, -1]) * s, s, 1.0])
             @ np.array([[1, 0, -rng.uniform(0, w)], [0, 1, -rng.uniform(0, h)],
                         [0, 0, 1]]))
        if i % 3 == 1:
            T = np.array([[1, 0, -rng.uniform(0, 500 * f)], [0, 1, -rng.uniform(0, 300 * f)],
                          [0, 0, 1]]) @ T
        elif i % 3 == 2 and projective:
            T[2, :2] = rng.uniform(-2e-4, 2e-4, 2)
        out.append(T.astype(np.float32))
    return out


@pytest.mark.parametrize("kind", ["augmenter", "general"])
def test_inverse_coefficients_are_jax_bits(kind):
    if kind == "augmenter":
        mats = augmenter_like(600, 0)
    else:
        rng = np.random.default_rng(1)
        mats = [(rng.standard_normal((3, 3)) * rng.uniform(0.1, 100, (3, 3)))
                .astype(np.float32) for _ in range(300)]
    differ = [i for i, M in enumerate(mats)
              if not np.array_equal(inverse_coefficients(M), np.asarray(_jinv(M)).reshape(9))]
    assert differ == []


def test_inverse_coefficients_of_2x3_and_singular():
    A = np.asarray([[1.3, 0.0, -1.5], [0.0, 0.8, 2.0]], np.float32)
    full = np.concatenate([A, [[0, 0, 1]]]).astype(np.float32)
    np.testing.assert_array_equal(inverse_coefficients(A), np.asarray(_jinv(full)).reshape(9))
    with pytest.raises(ValueError):
        inverse_coefficients(np.asarray([[1, 2, 0], [2, 4, 0], [0, 0, 1]], np.float32))


@pytest.mark.parametrize("mode", ["nearest", "bicubic"])
def test_plain_warp_equals_jax_at_480x854(mode):
    """With np.linalg.inv's float32 inverse, which differs from JAX's by one
    ulp in one entry, nearest differed in 3 values (by up to 197.9 on this
    0..255 source) and bicubic by up to 0.0215; with JAX's bits it is equal."""
    src = (np.random.default_rng(2).random((480, 854, 3)) * 255).astype(np.float32)
    want = np.asarray(jax_warp(jnp.asarray(src), T_SMOKE, (480, 854), mode=mode))
    got = warp_affine_plain(torch.from_numpy(np.ascontiguousarray(src.transpose(2, 0, 1))),
                            inverse_coefficients(T_SMOKE), (480, 854), mode)
    np.testing.assert_array_equal(got.numpy().transpose(1, 2, 0), want)


_TAPS = {"nearest": (0, 1), "bilinear": (0, 2), "bicubic": (-1, 4)}


def tile_boxes(hinv, size, mode):
    """Each output tile's source box as the staged kernel computes it: the
    map at the tile's four corners in float32 (a rounded product, then
    rounded sums, as on the card), the tap base (floor, or floor(x + 0.5)
    for nearest), then the mode's taps. float32 arrays x_lo, y_lo, x_hi,
    y_hi, one entry per tile."""
    h = np.asarray(hinv, np.float32).reshape(9)
    (oh, ow), (ty, tx) = size, STAGED_TILE
    lo, n = _TAPS[mode]
    xa = np.arange(0, ow, tx, dtype=np.float32)
    xb = (np.minimum(xa + tx, ow) - 1).astype(np.float32)
    ya = np.arange(0, oh, ty, dtype=np.float32)[:, None]
    yb = (np.minimum(ya + ty, oh) - 1).astype(np.float32)
    bx, by = [], []
    for x, y in ((xa, ya), (xb, ya), (xa, yb), (xb, yb)):
        xs = (h[0] * x + h[1] * y) + h[2]
        ys = (h[3] * x + h[4] * y) + h[5]
        if mode == "nearest":
            xs, ys = xs + np.float32(0.5), ys + np.float32(0.5)
        bx.append(np.floor(xs))
        by.append(np.floor(ys))
    bx, by = np.stack(bx), np.stack(by)
    return bx.min(0) + lo, by.min(0) + lo, bx.max(0) + lo + n - 1, by.max(0) + lo + n - 1


def _augmenter_transforms():
    """Every forward map the augmenter's eval parameter lists can give:
    foreground specs (each rotation, mirror, scale and skew) for a small and
    a large target, and the background specs, at 480x854."""
    im = (480, 854)
    aug = ImageAugmenter(eval_aug_params(5), device="cpu")
    fg = eval_aug_params(5)["fg_aug_params"]
    bg = eval_aug_params(5)["bg_aug_params"]
    out = []
    for bbox in [(427.0, 240.0, 120, 120), (400.0, 250.0, 700, 420)]:
        for a in fg["rotation"]:
            for flip in (False, True):
                for s in fg["scale"]:
                    for k in fg["skew"]:
                        spec = AugSpec((0.3, 0.6), a, flip, s, k)
                        out.append(aug.get_transform(spec, bbox, im)[0])
    for s in bg["scale"]:
        spec = AugSpec((0.5, 0.5), 0, False, s, (0.0, 0.0))
        out.append(aug.get_transform(spec, (427.0, 240.0, 854, 480), im, limit_scale=False)[0])
    return out


@pytest.mark.parametrize("mode", ["nearest", "bicubic"])
def test_augmenter_warps_plan_staged(mode):
    """The augmenter's background warps (full frame) and foreground warps
    (into the 200x240 paste box and the full frame) all take the staged
    kernel: the planned box, which holds every tile's, fits its shared
    memory in all channels."""
    shift = np.array([[1, 0, -150.0], [0, 1, -100.0], [0, 0, 1]])
    channels = 4 if mode == "bicubic" else 1     # RGBA targets, 0/1 label planes
    plans = set()
    for T in _augmenter_transforms():
        for M, size in [(T, (480, 854)), (shift @ T, (200, 240))]:
            hinv = inverse_coefficients(M)
            plan = plan_warp(hinv, size, mode, channels)
            plans.add(plan.variant)
            xlo, ylo, xhi, yhi = tile_boxes(hinv, size, mode)
            assert plan.box[0] >= (yhi - ylo).max() + 1
            assert plan.box[1] >= (xhi - xlo).max() + 3
    assert plans == {"staged"}


def test_projective_and_oversized_maps_plan_direct():
    """Projective maps, a shrink whose tile boxes exceed the shared memory,
    and more channels than it holds take the direct kernel."""
    for M in augmenter_like(30, 3)[2::3]:
        assert plan_warp(inverse_coefficients(M), (480, 854), "bicubic", 3).variant == "direct"
    # shrinking by 5 at 45 degrees: a 16x32 tile reads a ~170x170 box
    a = np.deg2rad(45)
    shrink = np.array([[0.2 * np.cos(a), 0.2 * np.sin(a), 200.0],
                       [-0.2 * np.sin(a), 0.2 * np.cos(a), 100.0], [0, 0, 1]])
    assert plan_warp(inverse_coefficients(shrink), (480, 854), "bicubic", 1).variant == "direct"
    # a box that fits one channel but not 64 of them
    assert plan_warp(inverse_coefficients(np.eye(3)), (480, 854), "bicubic", 1).variant \
        == "staged"
    assert plan_warp(inverse_coefficients(np.eye(3)), (480, 854), "bicubic", 64).variant \
        == "direct"


def test_plan_lane_mapping():
    """Warps take 8x4 output patches, so the planned box rows have a pitch
    of 8 mod 32 words, for rotated and axis-aligned maps alike; where that
    wider pitch would not fit the shared memory, the pitch is the box's width."""
    scaled = np.array([[1.2, 0, -85.4], [0, 1.2, -48.0], [0, 0, 1]])
    for M in (T_SMOKE, scaled):
        plan = plan_warp(inverse_coefficients(M), (480, 854), "bicubic", 3)
        assert plan.variant == "staged" and plan.box[1] % 32 == 8
    wide = plan_warp(inverse_coefficients(np.eye(3)), (480, 854), "bicubic", 30)
    tight = plan_warp(inverse_coefficients(np.eye(3)), (480, 854), "bicubic", 32)
    assert wide.box[1] % 32 == 8 and tight.variant == "staged"
    assert tight.box[0] == wide.box[0] and tight.box[1] < wide.box[1]
    assert 4 * 32 * tight.box[0] * tight.box[1] <= STAGED_SMEM_BYTES


def _tile_reduce(v, tile, fn, fill):
    oh, ow = v.shape
    ny, nx = -(-oh // tile[0]), -(-ow // tile[1])
    p = np.full((ny * tile[0], nx * tile[1]), fill, v.dtype)
    p[:oh, :ow] = v
    return fn(fn(p.reshape(ny, tile[0], nx, tile[1]), axis=3), axis=1)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_tile_boxes_hold_every_tap(mode):
    """For 200 seeded affine maps (60x90 source, 50x70 output: partly and
    fully off-frame tiles, mirrors, skew, steps up to 4), each tile's box
    holds every tap of every pixel of the tile, as the plain warp computes
    the taps, where the box meets the source; where it misses the source, no
    tap of the tile lands in it (the kernel writes zeros). The planned box
    is at least as large as every tile's, with room to widen it to column
    pairs."""
    H, W = 60, 90
    lo, n = _TAPS[mode]
    for M in augmenter_like(200, 7, hw=(H, W), projective=False):
        hinv = inverse_coefficients(M)
        xs, ys = (c[0] for c in _inverse_map(hinv[None], 50, 70, "cpu"))
        if mode == "nearest":
            xs, ys = xs + 0.5, ys + 0.5
        bx, by = torch.floor(xs).numpy() + lo, torch.floor(ys).numpy() + lo
        xlo, ylo, xhi, yhi = tile_boxes(hinv, (50, 70), mode)
        plan = plan_warp(hinv, (50, 70), mode, 1)
        assert plan.box[0] >= (yhi - ylo).max() + 1
        assert plan.box[1] >= (2 * np.floor(xhi / 2) + 1 - 2 * np.floor(xlo / 2)).max() + 1
        hit = (xhi >= 0) & (xlo <= W - 1) & (yhi >= 0) & (ylo <= H - 1)
        t = STAGED_TILE
        assert np.all(~hit | (_tile_reduce(bx, t, np.min, np.inf) >= xlo))
        assert np.all(~hit | (_tile_reduce(by, t, np.min, np.inf) >= ylo))
        assert np.all(~hit | (_tile_reduce(bx, t, np.max, -np.inf) + n - 1 <= xhi))
        assert np.all(~hit | (_tile_reduce(by, t, np.max, -np.inf) + n - 1 <= yhi))
        inside = ((bx + n - 1 >= 0) & (bx <= W - 1) & (by + n - 1 >= 0) & (by <= H - 1))
        assert not np.any(_tile_reduce(inside, t, np.max, False) & ~hit)


def test_affine_inverse_bottom_row_is_exact():
    """The staged kernel drops the homogeneous divide: for any affine input
    the inverse's bottom row is exactly (0, 0, 1), so the divide was by 1."""
    rng = np.random.default_rng(4)
    for _ in range(3000):
        A = (rng.standard_normal((2, 3)) * rng.uniform(0.01, 500, (2, 3))).astype(np.float32)
        if abs(np.linalg.det(A[:, :2].astype(np.float64))) < 1e-6:
            continue
        h = inverse_coefficients(A if rng.random() < 0.5 else np.concatenate([A, [[0, 0, 1]]]))
        assert h[6] == 0 and h[7] == 0 and h[8] == 1
