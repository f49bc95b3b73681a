"""The port's warp inverse against JAX's, bit for bit.

`inverse_coefficients` repeats, in float32, the roundings of
`jnp.linalg.inv` on the CPU (LAPACK sgetrf and two strsm), so the port's
warp maps every output pixel to the same source coordinates as frtm_tpu's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frtm_tpu.ops.warp import warp_affine as jax_warp
from frtm_tpu_torch.ops.warp import inverse_coefficients, warp_affine_plain

_jinv = jax.jit(jnp.linalg.inv)

# chip_smoke.py's background warp: rotation 0.3 rad, scale 1.2, shift
T_SMOKE = np.array([[1.2 * np.cos(0.3), 1.2 * np.sin(0.3), -60.0],
                    [-1.2 * np.sin(0.3), 1.2 * np.cos(0.3), 90.0], [0, 0, 1]])


def augmenter_like(n, seed):
    """Seeded forward maps as ImageAugmenter.get_transform builds them
    (translate @ skew @ rotate @ scale/mirror @ translate) at 480x854; every
    third is shifted to a paste sub-box, every third made mildly projective."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = np.deg2rad(rng.choice([5, -5, 10, -10, 20, -20, 30, -30, 45, -45, 60, -60]))
        s = rng.choice([0.7, 1.0, 1.5, 2.0]) * rng.uniform(0.5, 2.0)
        k = rng.choice([0.0, 0.1])
        T = (np.array([[1, 0, rng.uniform(0, 854)], [0, 1, rng.uniform(0, 480)], [0, 0, 1]])
             @ np.array([[1, k, 0], [k, 1, 0], [0, 0, 1]])
             @ np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]])
             @ np.diag([rng.choice([1, -1]) * s, s, 1.0])
             @ np.array([[1, 0, -rng.uniform(0, 854)], [0, 1, -rng.uniform(0, 480)],
                         [0, 0, 1]]))
        if i % 3 == 1:
            T = np.array([[1, 0, -rng.uniform(0, 500)], [0, 1, -rng.uniform(0, 300)],
                          [0, 0, 1]]) @ T
        elif i % 3 == 2:
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
