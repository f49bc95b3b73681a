"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Elsewhere every test skips. Tolerances: pyrup and the warp repeat the plain
version's float operations in the same order without FMA contraction, so they
must agree bit for bit; the head conv sums 9 * Cin products with FMA in
another order, so it is held to 5e-5 absolute at unit-scale inputs. The
bfloat16 instances compute in float32 and round once, like their plain
versions: pyrup bit for bit again; the head conv within one bfloat16 ulp at
the output's peak (a float32 sum that differs in its last bits can round to
the neighbouring bfloat16 value).
"""
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from frtm_tpu_torch.device import resolve_device
from frtm_tpu_torch.ops.kernels import (LAUNCHES, VARIANTS, conv3x3_cout1,
                                        conv3x3_cout1_input_grad,
                                        conv3x3_cout1_input_grad_plain, conv3x3_cout1_plain,
                                        conv3x3_cout1_weight_grad,
                                        conv3x3_cout1_weight_grad_plain, pyr_up_bicubic,
                                        pyr_up_bicubic_backward, pyr_up_bicubic_backward_plain,
                                        pyr_up_bicubic_plain, warp_affine,
                                        warp_affine_batched)
from frtm_tpu_torch.ops.kernels.build import DTYPES
from frtm_tpu_torch.ops.warp import inverse_coefficients, warp_affine_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    resolve_device("cuda")
    return torch.Generator().manual_seed(0)


# the main path's two stages, N=2 (the host loop with two objects), N=8
# (the fused tracker's decode window), and N=16 and 40 (that window with 2
# and 5 objects); YouTube-VOS's stages at 720x1280 (W = 320 and 640: 640-
# and 1280-byte rows); odd W (2W = 2 mod 4: 8-byte stores); 2W just below,
# at and above the float32 kernel's 128-column tile (W = 63, 64, 65, 66); H
# below and just above its 32-row-pair tile (H = 5, 32, 33); a single
# pixel. For the bfloat16 design: H = 7, 8, 9 and 17 where the planes are
# many enough for its longest chunks (8 row pairs; a thread walks them 5 at a
# time); planes so narrow that every thread's patch touches a border (W = 2,
# 3, 4, 6)
@pytest.mark.parametrize("shape", [(1, 32, 120, 214), (1, 16, 240, 428), (8, 32, 120, 214),
                                   (16, 32, 120, 214), (16, 16, 240, 428),
                                   (40, 32, 120, 214), (40, 16, 240, 428), (2, 3, 7, 5),
                                   (1, 1, 1, 1), (1, 2, 9, 131),
                                   (1, 3, 5, 63), (1, 3, 32, 64), (1, 3, 17, 65),
                                   (2, 2, 33, 66), (2, 32, 120, 214), (2, 16, 240, 428),
                                   (1, 32, 180, 320), (1, 16, 360, 640), (2, 16, 720, 1280),
                                   (80, 64, 7, 128), (80, 64, 8, 128),
                                   (80, 64, 9, 128), (80, 64, 17, 128), (1, 3, 6, 2), (1, 3, 4, 3), (1, 2, 5, 4),
                                   (1, 2, 3, 6)])
@pytest.mark.parametrize("instance", ["f32", "bf16"])
def test_pyrup_kernel_is_bit_exact(gen, shape, instance):
    """In bfloat16 the input rows are 4-byte (W = 2 mod 4), 8-byte (W = 4
    mod 8) or 16-byte (W = 0 mod 8) aligned and read as 4-byte words, or
    only 2-byte aligned (W odd) and read value by value; output rows take
    16-byte stores (W = 0 mod 4), 16- and 8-byte stores on alternate rows
    (W = 2 mod 4), or 4-byte stores (W odd)."""
    x = torch.randn(shape, generator=gen).cuda().to(DTYPES[instance])
    before, vbefore = LAUNCHES["pyrup"], dict(VARIANTS["pyrup"])
    got = pyr_up_bicubic(x)
    assert LAUNCHES["pyrup"] == before + 1
    assert VARIANTS["pyrup"][instance] == vbefore[instance] + 1
    assert got.dtype == x.dtype
    assert torch.equal(got, pyr_up_bicubic_plain(x))
    if instance == "bf16":      # and the plain version is the float32 one, rounded once
        assert torch.equal(got, pyr_up_bicubic_plain(x.float()).to(torch.bfloat16))


# the head conv at N=1, 2, 8, 16 and 40 (the batch is the grid's z extent,
# limit 65535), and at YouTube-VOS's 720x1280; Cin 1, 3, 5, 16, 32 and 64
# (the bfloat16 design stages 4 channels at a time: 1, 3 and 5 leave a stage
# part empty); rows only 4-byte aligned (W = 129, 127: 4-byte copies); H
# below (4, 5, 7, 9, 15), at (16) and just above (17) the 16-row tile, the
# last three with enough blocks for the bfloat16 design's wide tile (128
# columns; N = 1 and 2 at 480x854 take its narrow one, 64)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(1, 16, 480, 854), (8, 16, 480, 854), (16, 16, 480, 854),
                                   (40, 16, 480, 854), (2, 3, 5, 129),
                                   (1, 64, 17, 33), (1, 1, 9, 130), (3, 1, 4, 7),
                                   (1, 3, 7, 127), (2, 16, 480, 854),
                                   (1, 32, 180, 320), (1, 16, 360, 640), (2, 16, 720, 1280),
                                   (300, 3, 15, 130), (300, 5, 16, 130), (300, 3, 17, 130)])
@pytest.mark.parametrize("instance", ["f32", "bf16"])
def test_conv3x3_cout1_kernel_matches_plain(gen, shape, bias, instance):
    dtype = DTYPES[instance]
    x = torch.randn(shape, generator=gen).cuda().to(dtype)
    w = (torch.rand(1, shape[1], 3, 3, generator=gen) * 0.2 - 0.1).cuda().to(dtype)
    b = torch.randn(1, generator=gen).cuda().to(dtype) if bias else None
    vbefore = dict(VARIANTS["conv3x3_cout1"])
    got = conv3x3_cout1(x, w, b)
    assert VARIANTS["conv3x3_cout1"][instance] == vbefore[instance] + 1
    want = conv3x3_cout1_plain(x, w, b)
    assert got.dtype == want.dtype == dtype
    if instance == "f32":
        torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
        return
    # nearly every value is the same bfloat16 number
    assert _differing_within_one_ulp(got, want) < 0.02


def _misaligned(shape, offset, dtype, gen):
    """A contiguous view of `shape` whose data pointer lies `offset` elements
    past an aligned allocation."""
    n = math.prod(shape)
    base = torch.randn(n + offset, generator=gen).cuda().to(dtype)
    x = base[offset:].view(shape)
    assert x.data_ptr() % 16 == offset * base.element_size() % 16
    return x


# storage offsets of 1 (a 2-byte aligned pointer: value-by-value loads) and
# 2 elements (4-byte aligned, not 8) in bfloat16
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("shape", [(1, 32, 120, 214), (2, 16, 240, 428), (1, 3, 9, 64),
                                   (1, 2, 5, 7)])
def test_pyrup_bf16_reads_misaligned_views(gen, shape, offset):
    x = _misaligned(shape, offset, torch.bfloat16, gen)
    before = VARIANTS["pyrup"]["bf16"]
    got = pyr_up_bicubic(x)
    assert VARIANTS["pyrup"]["bf16"] == before + 1
    assert torch.equal(got, pyr_up_bicubic_plain(x))


def _differing_within_one_ulp(got, want):
    """Checks got within one bfloat16 ulp of want at want's peak; returns the
    share of values that differ."""
    peak = float(want.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(peak)) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp
    return float((got != want).float().mean())


# the decoder's own inputs (ReLU outputs) at its shapes: 99.99 % of values
# equal (on unit normal inputs, whose sums cancel more, 99.989 % was read)
@pytest.mark.parametrize("shape", [(1, 16, 480, 854), (16, 16, 480, 854), (2, 16, 720, 1280)])
def test_conv3x3_cout1_bf16_on_decoder_inputs(gen, shape):
    x = torch.relu(torch.randn(shape, generator=gen)).cuda().to(torch.bfloat16)
    w = (torch.rand(1, shape[1], 3, 3, generator=gen) * 0.2 - 0.1).cuda().to(torch.bfloat16)
    b = (torch.rand(1, generator=gen) * 0.2 - 0.1).cuda().to(torch.bfloat16)
    assert _differing_within_one_ulp(conv3x3_cout1(x, w, b), conv3x3_cout1_plain(x, w, b)) <= 1e-4


# a misaligned input view (value-by-value staging), odd W with it, and a Cin
# whose weights take the shared memory past 48 KB
@pytest.mark.parametrize("offset,shape", [(1, (1, 16, 480, 854)), (1, (16, 16, 64, 130)),
                                          (1, (2, 3, 17, 127)), (0, (2, 1000, 9, 130))])
def test_conv3x3_cout1_bf16_odd_inputs(gen, offset, shape):
    x = _misaligned(shape, offset, torch.bfloat16, gen)
    w = (torch.rand(1, shape[1], 3, 3, generator=gen) * 0.2 - 0.1).cuda().to(torch.bfloat16)
    b = torch.randn(1, generator=gen).cuda().to(torch.bfloat16)
    before = VARIANTS["conv3x3_cout1"]["bf16"]
    got = conv3x3_cout1(x, w, b)
    assert VARIANTS["conv3x3_cout1"]["bf16"] == before + 1
    assert _differing_within_one_ulp(got, conv3x3_cout1_plain(x, w, b)) < 0.02


_MATS = {
    "rot": np.asarray([[0.94, -0.34, 3.2], [0.34, 0.94, -2.1], [0, 0, 1]], np.float32),
    "scale2x3": np.asarray([[1.3, 0.0, -1.5], [0.0, 0.8, 2.0]], np.float32),
    "projective": np.asarray([[1.0, 0.1, 2.0], [0.05, 0.9, -1.0], [1e-3, -2e-3, 1.0]],
                             np.float32),
    "off_frame": np.asarray([[1.0, 0.0, 500.0], [0.0, 1.0, 500.0], [0, 0, 1]], np.float32),
}


def _warp_checked(src, M, size, mode, variant):
    """The kernel's warp, checked to launch once, by `variant`, and to equal
    the plain version bit for bit."""
    want = warp_affine_plain(src, inverse_coefficients(M), size, mode)
    before, vbefore = LAUNCHES["warp_affine"], dict(VARIANTS["warp_affine"])
    got = warp_affine(src, M, size, mode)
    assert LAUNCHES["warp_affine"] == before + 1
    assert VARIANTS["warp_affine"][variant] == vbefore[variant] + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("mat", sorted(_MATS))
def test_warp_kernel_is_bit_exact(gen, mode, mat):
    src = (torch.rand(4, 48, 85, generator=gen) * 255).cuda()
    _warp_checked(src, _MATS[mat], (40, 90), mode,
                  "direct" if mat == "projective" else "staged")


def _affine(angle, scale, flip=False, skew=0.0, to=(120.0, 100.0), frm=(160.0, 120.0)):
    """The augmenter's map: the source point `frm` to the output point `to`,
    with mirror, scale, rotation (degrees) and skew about it."""
    a = np.deg2rad(angle)
    return (np.array([[1, 0, to[0]], [0, 1, to[1]], [0, 0, 1]])
            @ np.array([[1, skew, 0], [skew, 1, 0], [0, 0, 1]])
            @ np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]])
            @ np.diag([-scale if flip else scale, scale, 1.0])
            @ np.array([[1, 0, -frm[0]], [0, 1, -frm[1]], [0, 0, 1]]))


# (channels, map, output size, variant) on a 240x320 source: inverse step 2
# at 45 degrees (the augmenter's worst footprint), mirrors and skew, output
# boxes of one pixel, 3x5 and odd widths (ragged tiles), C = 1, 2, 3, 4,
# 480x854 outputs rotated (most tiles border) and axis-aligned (the eval
# background's map), footprints partly and fully off the frame, and a
# shrink by 5, or 40 channels, whose boxes exceed the shared-memory budget
_WARPS = {
    "step2_45deg": (4, _affine(45, 0.5), (200, 240), "staged"),
    "step2_skew_flip": (4, _affine(-45, 0.5, flip=True, skew=0.1), (200, 240), "staged"),
    "flip": (3, _affine(20, 1.3, flip=True), (200, 240), "staged"),
    "skew": (3, _affine(-30, 0.7, skew=0.1), (131, 97), "staged"),
    "one_pixel": (4, _affine(10, 1.5), (1, 1), "staged"),
    "3x5": (3, _affine(30, 2.0), (3, 5), "staged"),
    "odd_width": (1, _affine(-10, 1.0), (37, 33), "staged"),
    "c1": (1, _affine(5, 1.2), (480, 854), "staged"),
    "axis_aligned": (3, _affine(0, 1.2), (480, 854), "staged"),
    "c2": (2, _affine(-60, 1.7), (120, 150), "staged"),
    "partly_off": (3, _affine(60, 0.7, to=(50.0, 50.0), frm=(10.0, 10.0)), (100, 130),
                   "staged"),
    "fully_off": (4, _affine(0, 1.0, to=(0.0, 0.0), frm=(900.0, 900.0)), (64, 96), "staged"),
    "over_budget": (3, _affine(45, 0.2), (200, 240), "direct"),
    "channels_over_budget": (40, _affine(10, 1.0), (64, 96), "direct"),
}


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("case", sorted(_WARPS))
def test_warp_variants_are_bit_exact(gen, mode, case):
    c, M, size, variant = _WARPS[case]
    src = (torch.rand(c, 240, 320, generator=gen) * 255).cuda()
    _warp_checked(src, M, size, mode, variant)


_OVER_PLAN = """
import ctypes, torch
from frtm_tpu_torch.ops.kernels import build
from frtm_tpu_torch.ops.kernels.warp_affine import _ARGTYPES
src = torch.rand(1, 64, 64, device="cuda")
out = torch.empty(1, 32, 32, device="cuda")
fn = build.library("warp_affine").frtm_warp_affine_maps_f32
fn.argtypes = _ARGTYPES + [ctypes.c_int, ctypes.c_void_p]
identity = (ctypes.c_float * 9)(1, 0, 0, 0, 1, 0, 0, 0, 1)
# a planned box of 2x2 against the identity's ~20x38 tile boxes
assert fn(src.data_ptr(), out.data_ptr(), 1, 0, 64, 64, 32, 32, identity, 1, 2, 2, 2, 0,
          None) == 0
try:
    torch.cuda.synchronize()
    print("no error")
except RuntimeError as e:
    print("launch failed:", e)
"""


def test_staged_warp_fails_on_a_box_over_its_plan(gen):
    """A tile whose source box exceeds the planned box stops the staged
    launch with an error; nothing stands in for it. In a child process,
    since the error leaves that process's CUDA context unusable."""
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", _OVER_PLAN], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert "launch failed" in r.stdout, r.stdout + r.stderr


# (source planes, nearest_from, maps, output size, variant) of the batched
# and mixed launches: the augmenter's paste (RGBA + label, one map), its
# batched rounds (4 and 19 maps; 33 take two launches), maps whose boxes
# differ (the launch stages the largest), a batch with a projective map or
# with a footprint over the budget (DIRECT for all), and mixed batches
_BATCHES = {
    "paste_mixed": (5, 4, [_affine(30, 1.3)], (200, 240), "staged"),
    "paste_mixed_worst": (5, 4, [_affine(45, 0.5)], (200, 240), "staged"),
    "round4": (3, None, [_affine(10 * k, 0.6 + 0.3 * k) for k in range(4)], (131, 97),
               "staged_batched"),
    "round19": (4, None, [_affine(-45 + 5 * k, 0.5 + 0.1 * k, flip=k % 3 == 0)
                          for k in range(19)], (120, 150), "staged_batched"),
    "two_launches": (1, None, [_affine(k, 1.0 + 0.01 * k) for k in range(33)], (37, 33),
                     "staged_batched"),
    "mixed_round": (5, 4, [_affine(20 * k, 1.5 - 0.2 * k) for k in range(5)], (64, 96),
                    "staged_batched"),
    "projective": (3, 2, [_affine(10, 1.0), _MATS["projective"]], (40, 90), "direct_batched"),
    "over_budget": (3, None, [_affine(0, 1.0), _affine(45, 0.2)], (64, 96), "direct_batched"),
}


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("case", sorted(_BATCHES))
def test_batched_and_mixed_warps_are_bit_exact(gen, mode, case):
    """Each map's output of a batched or mixed launch equals the one-map,
    one-mode plain warp of its planes, bit for bit; the launches take the
    named variant (one per 32 maps)."""
    c, nearest_from, Ms, size, variant = _BATCHES[case]
    src = (torch.rand(c, 240, 320, generator=gen) * 255).cuda()
    if nearest_from is not None:
        src[nearest_from:] = (src[nearest_from:] > 128).float()
    k = c if nearest_from is None else nearest_from
    batched = len(Ms) > 1
    before, vbefore = LAUNCHES["warp_affine"], dict(VARIANTS["warp_affine"])
    got = (warp_affine_batched(src, Ms, size, mode, nearest_from) if batched
           else warp_affine(src, Ms[0], size, mode, nearest_from)[None])
    n = -(-len(Ms) // 32)
    assert LAUNCHES["warp_affine"] == before + n
    assert VARIANTS["warp_affine"][variant] == vbefore[variant] + n
    assert got.shape == (len(Ms), c) + size
    for i, M in enumerate(Ms):
        h = inverse_coefficients(M)
        assert torch.equal(got[i, :k], warp_affine_plain(src[:k], h, size, mode)), i
        assert torch.equal(got[i, k:], warp_affine_plain(src[k:], h, size, "nearest")), i


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_warp_perspective_and_remap_match_plain(gen, mode):
    """warp_perspective on the card (kernel 3, its direct variant for a
    projective map) equals the plain warp bit for bit; remap, plain torch on
    both devices, gives the CPU's bits on the card."""
    from frtm_tpu_torch.ops.warp import remap, warp_perspective
    src = (torch.rand(3, 120, 160, generator=gen) * 255).cuda()
    P = _MATS["projective"]
    before = dict(VARIANTS["warp_affine"])
    got = warp_perspective(src, P, (100, 140), mode)
    assert VARIANTS["warp_affine"]["direct"] == before["direct"] + 1
    assert torch.equal(got, warp_affine_plain(src, inverse_coefficients(P), (100, 140), mode))
    yy, xx = np.mgrid[0:90, 0:130].astype(np.float32)
    map_x = xx * 1.3 - 3.7 + 2.0 * np.sin(yy / 3.0)
    map_y = yy * 1.2 - 2.1 + 1.5 * np.cos(xx / 4.0)
    assert torch.equal(remap(src, map_x, map_y, mode).cpu(),
                       remap(src.cpu(), map_x, map_y, mode))


@pytest.mark.parametrize("size", [(96, 128), (240, 427)])
def test_device_augmenter_on_the_card_matches_the_cpu(gen, size):
    """The device augmenter's batches on the card against the same call on
    the CPU: every round's counts and the labels equal, the images at most
    one grey level apart on under 0.1 % of the values (the blur's sums)."""
    from frtm_tpu_torch.config import eval_aug_params
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.models import device_augmenter as tda
    seq = make_moving_square_sequence(n_frames=2, size=size, square=size[0] // 4,
                                      n_objects=2, seed=1)
    mask = (seq.labels[0][..., 0] == 2).astype(np.float32)[..., None]
    counts, inner = {}, tda.batch_augment
    out = {}
    for dev in ("cuda", "cpu"):
        def spy(*args, dev=dev):
            r = inner(*args)
            counts.setdefault(dev, []).append(r[2].cpu().tolist())
            return r
        tda.batch_augment = spy
        try:
            before = dict(VARIANTS["warp_affine"])
            out[dev] = tda.DeviceAugmenter(eval_aug_params(5), dev).augment_first_frame(
                seq.images[0], mask, np.random.RandomState(0))
        finally:
            tda.batch_augment = inner
        if dev == "cuda":
            launched = {k: v - before[k] for k, v in VARIANTS["warp_affine"].items()}
            assert launched == {"staged": 0, "direct": 0, "direct_batched": 0,
                                "staged_batched": 3 * len(counts["cuda"])}
    assert counts["cuda"] == counts["cpu"]
    (ci, cl), (pi, pl) = out["cuda"], out["cpu"]
    assert torch.equal(cl.cpu(), pl)
    diff = (ci.cpu().float() - pi.float()).abs()
    assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("blur_size", [1.0, 5.0])
def test_host_augmenter_blur_on_the_card_equals_the_cpu(gen, blur_size):
    """The host augmenter's blur (models/augmenter.py::correlate_planes, its
    taps summed in frtm_tpu's CPU order) gives the CPU's bits on the card:
    the 3x3 and 7x7 kernels over (3, 480, 854), a flat region included."""
    from frtm_tpu_torch.models.augmenter import _rotate, blur_kernel, correlate_planes
    x = torch.rand(3, 480, 854, generator=gen) * 255
    x[:, :100, :200] = 37.0
    G = blur_kernel(blur_size, 0.1, _rotate(np.pi / 4)[:2, :2])
    assert G.shape == ((3, 3) if blur_size == 1.0 else (7, 7))
    assert torch.equal(correlate_planes(x.cuda(), G).cpu(), correlate_planes(x, G))


def test_warp_kernel_keeps_uint8_labels(gen):
    lbl = (torch.rand(1, 48, 85, generator=gen) > 0.5).to(torch.uint8).cuda()
    got = warp_affine(lbl, _MATS["rot"], (30, 40), "nearest")
    assert got.dtype == torch.uint8
    assert torch.equal(got.cpu(), warp_affine(lbl.cpu(), _MATS["rot"], (30, 40), "nearest"))


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(1, 4, 8, 10, generator=gen).cuda()
    with pytest.raises(TypeError):
        pyr_up_bicubic(x.double())
    with pytest.raises(ValueError):
        pyr_up_bicubic(x.transpose(2, 3))
    with pytest.raises(ValueError):
        conv3x3_cout1(x, torch.zeros(1, 3, 3, 3, device="cuda"))
    with pytest.raises(TypeError):      # one element type for input, weight and bias
        conv3x3_cout1(x.bfloat16(), torch.zeros(1, 4, 3, 3, device="cuda"))
    with pytest.raises(TypeError):
        conv3x3_cout1(x.half(), torch.zeros(1, 4, 3, 3, device="cuda").half())
    with pytest.raises(RuntimeError):   # weights and halos beyond 48 KB of shared memory
        conv3x3_cout1(torch.zeros(1, 926, 4, 4, device="cuda"),
                      torch.zeros(1, 926, 3, 3, device="cuda"))
    with pytest.raises(ValueError):
        warp_affine(x[0], np.eye(2), (8, 10))


def _launched_once(name, fn, variant="f32"):
    before, vbefore = LAUNCHES[name], VARIANTS[name][variant]
    out = fn()
    assert LAUNCHES[name] == before + 1 and VARIANTS[name][variant] == vbefore + 1
    return out


def _peak_err(got, want):
    return float((got - want).abs().max()), float(want.abs().max())


# pyrup's backward at the training shapes (N = 16, both stages) and at the
# edges of its design: H and W of 1 to 4 (every row and column a border
# one), odd W (8-byte loads), H around its chunks of 8 rows (7, 9, 17, with
# threads enough for the launch to pick 8 where an SM holds up to 1024),
# and gy views 4, 8 and 16 bytes past an aligned pointer (4-, 8- and 16-byte
# loads). The load width changes no sum, so every variant gives the bits of
# the aligned copy.
@pytest.mark.parametrize("shape,offset", [
    ((16, 32, 120, 214), 0), ((16, 16, 240, 428), 0), ((1, 1, 1, 1), 0), ((2, 3, 7, 5), 0),
    ((1, 32, 33, 65), 0), ((1, 1, 31, 97), 0), ((3, 2, 2, 130), 0), ((1, 4, 32, 32), 0),
    *[((1, 3, h, w), 0) for h in (2, 3, 4) for w in (2, 3, 4)],
    ((256, 32, 7, 64), 0), ((128, 32, 9, 64), 0), ((128, 32, 17, 64), 0),
    ((2, 8, 17, 214), 1), ((2, 8, 17, 214), 2), ((2, 8, 17, 214), 4), ((1, 3, 9, 7), 1)])
def test_pyrup_backward_kernel_matches_plain(gen, shape, offset):
    n, c, h, w = shape
    numel = n * c * 4 * h * w
    gy = torch.randn(numel + offset, generator=gen).cuda()[offset:].view(n, c, 2 * h, 2 * w)
    variant = {0: "v4", 1: "v1", 2: "v2", 4: "v4"}[offset]    # the widest the view allows
    if w % 2:
        variant = {"v4": "v2"}.get(variant, variant)            # rows of 8 mod 16 bytes
    got = _launched_once("pyrup_bwd", lambda: pyr_up_bicubic_backward(gy, shape), variant)
    err, peak = _peak_err(got, pyr_up_bicubic_backward_plain(gy, shape))
    assert err <= 1e-5 * peak
    assert torch.equal(got, pyr_up_bicubic_backward(gy, shape))    # no atomics
    if offset:
        assert torch.equal(got, pyr_up_bicubic_backward(gy.clone(), shape))
    x = torch.randn(shape, generator=gen).cuda().requires_grad_()
    pyr_up_bicubic(x).backward(gy)
    assert torch.equal(x.grad, got)


# The head conv's backward at the training shape and odd ones; for the
# weight gradient's streaming design also at its edges: H around its stripes
# (small grids take stripes of 8 rows: H = 7, 8, 9, 17), W around its column
# segments of 128 (126 .. 130), C around its groups of 4 and chunks of 16 (1,
# 3, 5, 17), and x and dy 4 bytes past an aligned pointer. For the input
# gradient's register walk: H around its stripes of 3 rows (1, 3, 4, 5, 6, 7,
# 8, 9, 17, 31, 32, 33), W of 1, 2, 3, odd W, W around its warps of 64
# columns (126 .. 130) and around a block's span of 14 warps (895, 896 in one
# block; 897, 898 in two segments of 8 warps), C around its groups of 4 (1,
# 3, 5, 17) and over 256 (300, 512). Odd W or such a view takes the 4-byte
# loads and stores (v1), else the 8-byte ones (v2); both widths give the same
# bits.
@pytest.mark.parametrize("shape,offset", [
    ((16, 16, 480, 854), 0), ((1, 1, 5, 7), 0), ((2, 32, 17, 129), 0), ((1, 3, 16, 128), 0),
    ((3, 1, 33, 257), 0), ((1, 1, 1, 1), 0),
    ((2, 5, 7, 40), 0), ((2, 5, 8, 40), 0), ((2, 5, 9, 40), 0), ((2, 5, 17, 40), 0),
    *[((1, 3, 9, w), 0) for w in (126, 127, 128, 129, 130)],
    ((1, 17, 9, 20), 0), ((2, 16, 17, 854), 1), ((1, 3, 9, 130), 1),
    ((2, 3, 1, 12), 0), ((2, 3, 5, 2), 0), ((2, 3, 5, 3), 0), ((1, 3, 6, 1), 0),
    ((1, 5, 3, 40), 0), ((1, 5, 4, 40), 0),
    ((1, 5, 31, 40), 0), ((1, 5, 32, 40), 0), ((1, 5, 33, 40), 0),
    *[((1, 2, 9, w), 0) for w in (895, 896, 897, 898)],
    ((1, 300, 9, 20), 0), ((1, 512, 3, 10), 0), ((2, 5, 9, 898), 1)])
def test_conv3x3_cout1_backward_kernels_match_plain(gen, shape, offset):
    from frtm_tpu_torch.ops.kernels.conv3x3_cout1 import input_grad_plan, weight_grad_plan
    n, c, h, wd = shape
    x = torch.randn(n * c * h * wd + offset, generator=gen).cuda()[offset:].view(shape)
    w = (torch.rand(1, c, 3, 3, generator=gen) * 0.2 - 0.1).cuda()
    b = torch.randn(1, generator=gen).cuda()
    gy = torch.randn(n * h * wd + offset, generator=gen).cuda()[offset:].view(n, 1, h, wd)
    if h <= 17:     # a grid of one wave: stripes of 8 rows
        assert weight_grad_plan(n, c, h, wd, x.device) == 8
    # the input gradient's blocks: whole rows up to 14 warps, wider rows in
    # segments of equal warps; stripes of 3 rows
    across = -(-((wd + 1) // 2) // 32)
    assert input_grad_plan(n, c, h, wd, "warps") == -(-across // -(-across // 14))
    assert input_grad_plan(n, c, h, wd) == 3
    width = "v1" if offset or wd % 2 else "v2"
    dx = _launched_once("conv3x3_cout1_dx", lambda: conv3x3_cout1_input_grad(gy, w, shape),
                        width)
    err, peak = _peak_err(dx, conv3x3_cout1_input_grad_plain(gy, w, shape))
    assert err <= 1e-5 * peak
    dw, db = _launched_once("conv3x3_cout1_dw", lambda: conv3x3_cout1_weight_grad(x, gy), width)
    pw, pb = conv3x3_cout1_weight_grad_plain(x, gy, w.shape)
    assert dw.shape == pw.shape and db.shape == pb.shape == (1,)
    err, peak = _peak_err(torch.cat([dw.flatten(), db]), torch.cat([pw.flatten(), pb]))
    assert err <= 1e-4 * peak
    dw2, db2 = conv3x3_cout1_weight_grad(x, gy)                    # no atomics
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert torch.equal(dx, conv3x3_cout1_input_grad(gy, w, shape))
    if width == "v2":       # the 4-byte loads on the same values: the same bits
        xv = torch.empty(x.numel() + 1, device="cuda")[1:].view(shape)
        gv = torch.empty(gy.numel() + 1, device="cuda")[1:].view(gy.shape)
        xv.copy_(x)
        gv.copy_(gy)
        dw1, db1 = _launched_once("conv3x3_cout1_dw", lambda: conv3x3_cout1_weight_grad(xv, gv),
                                  "v1")
        assert torch.equal(dw, dw1) and torch.equal(db, db1)
        dx1 = _launched_once("conv3x3_cout1_dx", lambda: conv3x3_cout1_input_grad(gv, w, shape),
                             "v1")
        assert torch.equal(dx, dx1)
    elif offset:            # and an aligned copy of a view takes the bits of the view
        dwa, dba = conv3x3_cout1_weight_grad(x.clone(), gy.clone())
        assert torch.equal(dw, dwa) and torch.equal(db, dba)
        dxa = _launched_once("conv3x3_cout1_dx",
                             lambda: conv3x3_cout1_input_grad(gy.clone(), w, shape),
                             "v1" if wd % 2 else "v2")
        assert torch.equal(dx, dxa)
    # through autograd: the same kernels, each launched once
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    before = dict(LAUNCHES)
    conv3x3_cout1(xr, wr, br).backward(gy)
    assert LAUNCHES["conv3x3_cout1_dx"] == before["conv3x3_cout1_dx"] + 1
    assert LAUNCHES["conv3x3_cout1_dw"] == before["conv3x3_cout1_dw"] + 1
    assert torch.equal(xr.grad, dx) and torch.equal(wr.grad, dw) and torch.equal(br.grad, db)


def test_input_grad_kernel_takes_channels_up_to_its_limit(gen):
    """csrc/conv3x3_cout1_dx.cu takes C up to kMaxChannels (65536) and refuses
    more; the wrapper raises on the refusal, with no plain fallback."""
    c = 1 << 16
    w = (torch.rand(1, c, 3, 3, generator=gen) * 0.2 - 0.1).cuda()
    gy = torch.randn(1, 1, 2, 6, generator=gen).cuda()
    dx = _launched_once("conv3x3_cout1_dx",
                        lambda: conv3x3_cout1_input_grad(gy, w, (1, c, 2, 6)), "v2")
    err, peak = _peak_err(dx, conv3x3_cout1_input_grad_plain(gy, w, (1, c, 2, 6)))
    assert err <= 1e-5 * peak
    before = LAUNCHES["conv3x3_cout1_dx"]
    w1 = torch.zeros(1, c + 1, 3, 3, device="cuda")
    with pytest.raises(RuntimeError):
        conv3x3_cout1_input_grad(gy, w1, (1, c + 1, 2, 6))
    assert LAUNCHES["conv3x3_cout1_dx"] == before


def test_bf16_instances_refuse_a_backward(gen):
    x = torch.randn(1, 4, 8, 10, generator=gen).cuda().bfloat16().requires_grad_()
    with pytest.raises(TypeError):
        pyr_up_bicubic(x).sum().backward()
    w = torch.zeros(1, 4, 3, 3, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(TypeError):
        conv3x3_cout1(x, w).sum().backward()
    with torch.no_grad():       # inference through the bf16 instances records nothing
        assert pyr_up_bicubic(x).grad_fn is None and conv3x3_cout1(x, w).grad_fn is None


def _small_fused_world(compute_dtype="float32"):
    from dataclasses import replace
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.models.resnet import resnet_out_channels
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
    from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network
    cfg = eval_config("resnet18", fast=True, num_aug=3, compute_dtype=compute_dtype)
    cfg = replace(cfg, disc=replace(cfg.disc, init_iters=(3, 5), update_iters=(3,),
                                    memory_size=8, c_channels=16, train_skipping=2))
    ch = {L: c for L, c in resnet_out_channels("resnet18").items() if L in cfg.refnet_layers}
    tracker = BatchedSequenceTracker(
        cfg, init_resnet("resnet18", torch.Generator().manual_seed(1)),
        init_seg_network(ch, torch.Generator().manual_seed(2)))
    assert tracker.device.type == "cuda"
    return tracker


@pytest.mark.parametrize("instance", ["f32", "bf16"])
def test_fused_tracker_decodes_through_the_kernels(gen, monkeypatch, instance):
    """The fused tracker's window decode on the card launches kernels 1 and 2
    (2 pyrups and 1 head conv per decode call) in the instance of its compute
    type and in no other, never their plain versions."""
    from importlib import import_module
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.ops.kernels import reset_launches

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    tracker = _small_fused_world({"f32": "float32", "bf16": "bfloat16"}[instance])
    seq = make_moving_square_sequence(n_frames=6, size=(96, 128), square=24, n_objects=2,
                                      seed=2)
    # the wrappers' own modules (the package re-exports the functions under
    # the same names)
    monkeypatch.setattr(import_module("frtm_tpu_torch.ops.kernels.pyrup"),
                        "pyr_up_bicubic_plain", refuse)
    monkeypatch.setattr(import_module("frtm_tpu_torch.ops.kernels.conv3x3_cout1"),
                        "conv3x3_cout1_plain", refuse)
    reset_launches()
    outputs, _ = tracker.run_sequence(seq)
    windows = 3                                  # 5 tracked frames, windows of 2
    other = "bf16" if instance == "f32" else "f32"
    assert LAUNCHES["pyrup"] == 2 * windows and LAUNCHES["conv3x3_cout1"] == windows
    assert VARIANTS["pyrup"] == {instance: 2 * windows, other: 0}
    assert VARIANTS["conv3x3_cout1"] == {instance: windows, other: 0}
    assert VARIANTS["warp_affine"]["direct"] == 0 and LAUNCHES["warp_affine"] > 0
    assert len(outputs) == 6 and all(o.shape == (96, 128) for o in outputs)
    if instance == "bf16":
        assert tracker.last_feats_dtype == torch.bfloat16


class _Dataset:
    """The least of a dataset that run_dataset reads."""
    name = "synthetic"

    def __init__(self, sequences):
        self.sequences = sequences

    def __iter__(self):
        return iter(self.sequences)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_pipelined_run_dataset_gives_the_same_labels(gen, tmp_path, compute_dtype):
    """run_dataset(pipeline=True) prepares sequence i + 1 on a second thread
    and a second CUDA stream while sequence i tracks; the tracker's stream
    waits on the preparation's event before it reads. A race would show as
    labels that differ from the unpipelined run's: the PNGs must be equal
    byte for byte, over several passes."""
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    tracker = _small_fused_world(compute_dtype)
    seqs = [make_moving_square_sequence(n_frames=9, size=(96, 128), square=24,
                                        n_objects=1 + i % 2, seed=10 + i, name=f"s{i}")
            for i in range(6)]
    tracker.run_dataset(_Dataset(seqs), tmp_path / "plain")
    for attempt in range(3):
        out = tmp_path / f"piped{attempt}"
        tracker.run_dataset(_Dataset(seqs), out, pipeline=True)
        for seq in seqs:
            for name in seq.frame_names:
                assert ((out / seq.name / f"{name}.png").read_bytes()
                        == (tmp_path / "plain" / seq.name / f"{name}.png").read_bytes()), \
                    (attempt, seq.name, name)


def test_count_host_syncs_sees_reads_and_blocking_uploads(gen):
    """The counter behind the fused tracker's `host_syncs`: a read and a
    blocking upload count, launches and views do not."""
    from frtm_tpu_torch.utils.profiling import count_host_syncs
    x = torch.ones(8, device="cuda")
    with count_host_syncs("cuda") as syncs:
        y = (x * 2).sum()
        z = y[None].expand(3)
    assert syncs.count == 0
    with count_host_syncs("cuda") as syncs:
        float(y)
        torch.arange(4.0).to("cuda")
    assert syncs.count == 2, syncs.where
    assert torch.cuda.get_sync_debug_mode() == 0 and z.shape == (3,)


def test_jpeg_backend_decodes_the_fixtures(gen):
    """The host library's JPEG backend on the card's machine decodes the
    committed fixtures (tests/data/torch_fixtures) to the manifest's sha256
    of PIL's decode where it is libjpeg-turbo; another decoder (IJG libjpeg,
    nvJPEG) upsamples chroma otherwise and must come within 0.5 dB of the
    manifest's PSNR against the source frame, rebuilt with numpy."""
    import hashlib
    import importlib.util
    import json
    from frtm_tpu_torch.data.image import imread
    from frtm_tpu_torch.utils import native
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "make_torch_jpeg_fixtures", root / "scripts" / "make_torch_jpeg_fixtures.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fixtures = root / "tests" / "data" / "torch_fixtures"
    manifest = json.loads((fixtures / "manifest.json").read_text())
    native.library()
    exact = native.JPEG_BACKEND.startswith("libjpeg-turbo")
    for name, entry in manifest["jpeg"].items():
        got = imread(fixtures / name)
        assert list(got.shape) == entry["shape"], name
        if exact:
            assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"], name
        assert abs(script.psnr(got, script.source_of(name)) - entry["psnr_db"]) <= 0.5, name
    (name, entry), = manifest["png"].items()
    assert hashlib.sha256(imread(fixtures / name).tobytes()).hexdigest() == entry["sha256"]


def _legacy_mode_readings(mode, seed=2, entry=3, layers=("layer5", "layer4"), score_gain=1.0):
    """The fused tracker's deferred merge at 480x854, two objects, with the
    target-model layers `layers` ('disc_layers') or the legacy 'thresh' update, run
    on the card and on the CPU (plain versions, no cuDNN), and on the CPU
    again with the input features moved by 1e-6 (the stem convolution
    scaled by 1 + 1e-6), the yardstick the CPU tests use for frtm_tpu.

    The random refiner's score inputs (the last channels of each TSE's first
    transform) are scaled by `score_gain` (1 in the test; larger gains made
    the fixture less well conditioned); the head is then scaled so that the
    CPU's frame-1 logits have median 0 and spread 2. Object 2 enters at frame
    `entry` (None: both at frame 0) of the sequence drawn from `seed`.
    Returns the soft volumes' largest gap and the labels' largest per-frame
    mismatch, card against CPU and nudged CPU against CPU, and the card's
    tracker."""
    import copy
    from dataclasses import replace
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.models.resnet import resnet_out_channels
    from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker, merge_volume
    from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network

    cfg = eval_config("resnet18", fast=True, num_aug=3)
    cfg = replace(cfg, disc=replace(cfg.disc, init_iters=(3, 5), update_iters=(3,),
                                    memory_size=8, c_channels=16, train_skipping=2))
    if mode == "disc_layers":
        cfg = replace(cfg, disc_layers=tuple(layers))
    else:
        cfg = replace(cfg, disc=replace(cfg.disc, update_method="thresh",
                                        cg_forgetting_rate=75))
    ch = {L: c for L, c in resnet_out_channels("resnet18").items() if L in cfg.refnet_layers}
    n_scores = max(1, len(cfg.disc_layers))
    backbone = init_resnet("resnet18", torch.Generator().manual_seed(1), "cpu")
    refiner = init_seg_network(ch, torch.Generator().manual_seed(2), in_channels=n_scores,
                               device="cpu")
    with torch.no_grad():
        for tse in refiner.TSE.values():
            tse.transform[0].weight[:, -n_scores:] *= score_gain

    def sequence(n_frames):
        seq = make_moving_square_sequence(n_frames=n_frames, size=(480, 854), square=120,
                                          n_objects=2, seed=seed)
        if entry is not None and n_frames > entry:
            seq.start_frames = {"00000": [1], f"{entry:05d}": [2]}
        return seq

    def run(dev, n_frames=5, bb=backbone):
        tracker = BatchedSequenceTracker(cfg, copy.deepcopy(bb), copy.deepcopy(refiner),
                                         merge_mode="deferred", device=dev)
        vol, _ = tracker.run_sequence(sequence(n_frames), soft=True)
        return vol, tracker

    vol, _ = run("cpu", n_frames=2)
    y = np.clip(vol[1].astype(np.float64), 1e-12, 1 - 1e-12)
    logits = np.log(y) - np.log1p(-y)
    with torch.no_grad():
        conv2 = refiner.project.conv2
        conv2.weight.mul_(2.0 / float(logits.std()))
        conv2.bias.sub_(float(np.median(logits))).mul_(2.0 / float(logits.std()))
    nudged = copy.deepcopy(backbone)
    with torch.no_grad():
        nudged.conv1.weight.mul_(1 + 1e-6)
    (cpu, _), (card, tracker) = run("cpu"), run("cuda")
    cpu_nudged, _ = run("cpu", bb=nudged)
    assert np.isfinite(card).all() and card.shape == (5, 2, 480, 854)
    lut = torch.tensor([0, 1, 2], dtype=torch.int32)
    labels = [merge_volume(torch.from_numpy(v), lut).numpy() for v in (cpu, card, cpu_nudged)]

    def gaps(other, other_labels):
        return (float(np.abs(cpu - other).max()),
                max(float(np.mean(a != b)) for a, b in zip(labels[0], other_labels)))
    (soft, mismatch), (soft_self, mismatch_self) = gaps(card, labels[1]), gaps(cpu_nudged,
                                                                                 labels[2])
    return {"soft": soft, "mismatch": mismatch, "soft_nudged": soft_self,
            "mismatch_nudged": mismatch_self}, tracker


@pytest.mark.parametrize("mode", ["disc_layers", "thresh"])
def test_fused_tracker_legacy_modes_match_the_cpu_path(gen, mode):
    """The fused tracker's deferred merge at 480x854 with two target-model
    layers (layer5 and layer4), and with the legacy 'thresh' update, object 2
    entering at frame 3, on the card against the same run on the CPU (plain
    versions, no cuDNN): soft volumes within 1e-2 and labels under 0.5 % of
    a frame, as the smoke's CPU-against-card run is held. The fixture must
    be well conditioned for that bound to mean anything: a 1e-6 nudge of the
    CPU run's features must move its labels on under 0.25 % of a frame.
    (With layer3's target model, random weights make the init solve
    ill-conditioned: the nudge alone moved labels by 1-2.6 %,
    scripts/torch_legacy_mode_conditioning.py.)"""
    readings, tracker = _legacy_mode_readings(mode)
    print(mode, readings)
    assert readings["mismatch_nudged"] < 2.5e-3, readings
    assert readings["soft"] <= 1e-2 and readings["mismatch"] < 5e-3, readings
    params, state = tracker.last_models            # one lane per object
    if mode == "disc_layers":
        assert set(params) == set(state) == {"layer4", "layer5"}
        assert [state[L].n_resolves.tolist() for L in ("layer4", "layer5")] == [[2, 0], [2, 0]]
    else:
        assert state.n_resolves.tolist() == [2, 0]


def test_train_step_launches_the_backward_kernels_and_reruns_bit_equal(gen):
    """One train step of the port's trainer (rn18, 96x128, batch 4, two train
    frames) on the card: per frame 2 pyrup, 1 head-conv, 2 pyrup-backward,
    1 dx and 1 dw launches; the loss and every gradient equal bit for bit
    when the step runs again from the same state (no atomics anywhere)."""
    from dataclasses import replace
    from frtm_tpu_torch.config import eval_config
    from frtm_tpu_torch.data.training_datasets import SampleSpec, SyntheticTrainingDataset
    from frtm_tpu_torch.models.resnet import resnet_out_channels
    from frtm_tpu_torch.runtime.trainer import TModelCache, TrainerModel
    from frtm_tpu_torch.utils.convert import init_resnet, init_seg_network
    cfg = eval_config("resnet18", fast=True, num_aug=3)
    cfg = replace(cfg, disc=replace(cfg.disc, c_channels=16, init_iters=(3, 5),
                                    update_iters=(3,), memory_size=8,
                                    pixel_weighting_method="none"))
    ch = {L: c for L, c in resnet_out_channels("resnet18").items() if L in cfg.refnet_layers}
    model = TrainerModel(cfg, init_resnet("resnet18", torch.Generator().manual_seed(1)),
                         init_seg_network(ch, torch.Generator().manual_seed(2)),
                         TModelCache(None, enable=False))
    assert model.device.type == "cuda"
    dset = SyntheticTrainingDataset(n_samples=4, size=(96, 128), sample_size=3, seed=0)
    items = [dset[i] for i in range(4)]
    images = np.stack([np.stack([it[0][t] for it in items]) for t in range(3)])
    labels = np.stack([np.stack([it[1][t] for it in items]) for t in range(3)])
    mask = np.asarray([1, 1, 1, 0], np.float32)
    disc, _ = model.build_disc_batch(images[0], labels[0],
                                     SampleSpec.from_encoded([it[2] for it in items]))
    state = {k: v.clone() for k, v in model.refiner.state_dict().items()}
    runs = []
    for _ in range(2):
        model.refiner.load_state_dict(state)
        model.refiner.zero_grad(set_to_none=True)
        before = dict(LAUNCHES)
        vbefore = {k: dict(v) for k, v in VARIANTS.items()}
        total, acc = model.loss(disc, images, labels, mask)
        total.backward()
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        assert launched == {"pyrup": 4, "conv3x3_cout1": 2, "warp_affine": 0, "pyrup_bwd": 4,
                            "conv3x3_cout1_dx": 2, "conv3x3_cout1_dw": 2}, launched
        # W = 128: the head conv's backward takes its 8-byte stores and loads
        assert {k: VARIANTS[k]["v2"] - vbefore[k]["v2"] for k in
                ("conv3x3_cout1_dx", "conv3x3_cout1_dw")} == {"conv3x3_cout1_dx": 2,
                                                              "conv3x3_cout1_dw": 2}
        runs.append((total.detach().clone(), acc.clone(),
                     {n: p.grad.clone() for n, p in model.refiner.named_parameters()},
                     {k: v.clone() for k, v in model.refiner.state_dict().items()}))
    (l0, a0, g0, s0), (l1, a1, g1, s1) = runs
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.parametrize("size", ["small", "eval"])
def test_batched_init_of_four_objects_on_the_card(gen, size):
    """disc_init of four objects at once on the card (grouped convolutions
    under cuDNN's deterministic algorithms): a second run equal bit for bit,
    and at the CPU tests' size (test_torch_batched_disc.py: 32 channels into
    8, 6x8 scores, 24x32 masks) each lane against the one-object solve of
    the same object within 1e-5 of its peak, the bound those tests hold the
    lanes to on the CPU. At the eval configuration's widths (1024 channels
    into 96, 30x54 scores, 480x854 masks, 6 samples, a memory of 80) the
    lanes are printed against their one-object solves; random features make
    that init ill-conditioned (F5), so no bound is set there."""
    from dataclasses import replace
    from frtm_tpu_torch.config import DiscConfig, eval_config
    from frtm_tpu_torch.models import discriminator as td
    if size == "small":
        cfg = DiscConfig(in_channels=32, c_channels=8, init_iters=(3, 5), update_iters=(3,),
                         memory_size=8, train_skipping=2)
        K, h, w, H, W = 3, 6, 8, 24, 32
    else:
        cfg = replace(eval_config("resnet101").disc)
        K, h, w, H, W = 6, 30, 54, 480, 854
    n = 4
    feats = torch.randn((n, K, cfg.in_channels, h, w), generator=gen).cuda()
    labels = torch.zeros((n, K, 1, H, W), device="cuda")
    for i in range(n):
        for k in range(K):
            y = int(torch.randint(0, H - H // 3, (1,), generator=gen))
            x = int(torch.randint(0, W - W // 3, (1,), generator=gen))
            labels[i, k, 0, y:y + H // 3, x:x + W // 3] = 1.0
    p0 = td.init_disc_params(cfg, gen, "cuda")
    runs = [td.disc_init(td.repeat_params(p0, n), feats, labels, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    (p, s), (q, r) = runs
    assert torch.equal(p.project, q.project) and torch.equal(p.filter, q.filter)
    assert torch.equal(s.cg.rho, r.cg.rho) and torch.equal(s.memory.weights, r.memory.weights)
    assert bool(torch.isfinite(p.filter).all()) and bool(torch.isfinite(p.project).all())
    gaps = []
    for i in range(n):
        one, _ = td.disc_init(td.repeat_params(p0, 1), feats[i:i + 1], labels[i:i + 1], cfg)
        for a, b in ((p.filter[i], one.filter[0]), (p.project[i], one.project[0])):
            gaps.append(float((a - b).abs().max() / b.abs().max()))
    print(size, "lanes against one-object solves, of the peak:", gaps)
    if size == "small":
        assert max(gaps) <= 1e-5, gaps


def test_kernel_records_follow_the_scan_forward_that_issued_them(gen):
    """The port's spans and torch.profiler's device records share one
    clock: in a profiled fused run every kernel-1 (pyrup) record starts
    after the start of the latest `scan_forward` span before it on the
    issuing thread (the window whose decode launched it), within 100 ms,
    and every window's decode has its records."""
    import threading
    from torch.profiler import ProfilerActivity, profile
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.utils import profiling
    tracker = _small_fused_world()
    seq = make_moving_square_sequence(n_frames=9, size=(96, 128), square=24, n_objects=2,
                                      seed=2)
    tracker.run_sequence(seq)           # builds and first launches outside the profile
    torch.cuda.synchronize()
    profiling.reset()
    try:
        with profiling.recording(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            tracker.run_sequence(seq)
            torch.cuda.synchronize()
        starts = sorted(s.start_ns for s in profiling.spans()
                        if s.name == "scan_forward" and s.thread == threading.get_ident())
    finally:
        profiling.reset()
    records = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                     if str(e.device_type()).endswith("CUDA") and "pyrup" in e.name().lower())
    assert len(starts) == 4 and records, (starts, records)       # 8 tracked frames, windows of 2
    issued_by = []
    for r in records:
        before = [s for s in starts if s <= r]
        assert before, (r - starts[0]) / 1e6
        assert r - before[-1] <= 100_000_000, (r - before[-1]) / 1e6
        issued_by.append(before[-1])
    assert set(issued_by) == set(starts)
    print("pyrup records after their scan_forward's start, ms:",
          [round((r - s) / 1e6, 3) for r, s in zip(records, issued_by)])


def _resolve_world(n, size, seed, cfg=None):
    """disc_init of n objects on the card from seeded features and boxes, at
    the CPU tests' size (32 channels into 8, 6x8 scores, 24x32 masks, a
    memory of 8) or the eval configuration's widths (1024 into 96, 30x54,
    480x854, a memory of 80), and the inserts of three frames after it, one
    a re-solve: (cfg, params, state, [(compressed, mask)] * 3)."""
    from dataclasses import replace
    from frtm_tpu_torch.config import DiscConfig, eval_config
    from frtm_tpu_torch.models import discriminator as td
    if cfg is None:
        cfg = (DiscConfig(in_channels=32, c_channels=8, init_iters=(3, 5), update_iters=(3,),
                          memory_size=8, train_skipping=2) if size == "small"
               else replace(eval_config("resnet101").disc))
    K, h, w, H, W = (3, 6, 8, 24, 32) if size == "small" else (6, 30, 54, 480, 854)
    g = torch.Generator().manual_seed(seed)

    def masks(count):
        out = torch.zeros((count, 1, H, W))
        for i in range(count):
            y = int(torch.randint(0, H - H // 3, (1,), generator=g))
            x = int(torch.randint(0, W - W // 3, (1,), generator=g))
            out[i, 0, y:y + H // 3, x:x + W // 3] = 1.0
        return out.cuda()

    feats = torch.randn((n, K, cfg.in_channels, h, w), generator=g).cuda()
    labels = masks(n * K).view(n, K, 1, H, W)
    p0 = td.init_disc_params(cfg, g, "cuda")
    params, state = td.disc_init(td.repeat_params(p0, n), feats, labels, cfg)
    frames = [(torch.randn((n, cfg.c_channels, h, w), generator=g).cuda(), masks(n))
              for _ in range(3)]
    return cfg, params, state, frames


def _resolve_runs(monkeypatch, maxsize, n, size, sequences=2):
    """Each of `sequences` sequences (its own disc_init, so its own memory
    allocations) inserts a frame and calls resolve_due three times, with the
    due masks alternating; then one filter_resolve (the host loop's call).
    Run with a fresh graph cache of `maxsize` keys (0: every call eager).
    Returns the filters and CG states after each call, the replays counted
    and the cache."""
    from frtm_tpu_torch.models import discriminator as td
    from frtm_tpu_torch.utils import profiling
    from frtm_tpu_torch.utils.cuda_graphs import GraphCache
    cache = GraphCache(maxsize)
    monkeypatch.setattr(td, "RESOLVE_GRAPHS", cache)
    dues = [[k % 2 == 0 for k in range(n)], [k % 2 == 1 for k in range(n)], [True] * n]
    got = []
    profiling.reset()
    try:
        with profiling.recording():
            for s in range(sequences):
                cfg, params, state, frames = _resolve_world(n, size, seed=10 + s)
                for (c, y), due in zip(frames, dues):
                    td.insert_sample(state, c, y, torch.ones(n, dtype=torch.bool, device="cuda"),
                                     [True] * n, cfg)
                    params = td.resolve_due(params, state, torch.tensor(due, device="cuda"), cfg)
                    got.append((params.filter, state.cg))
                params, cg = td.filter_resolve(params, state, cfg)
                got.append((params.filter, cg))
        torch.cuda.synchronize()
        replays = profiling.counts().get("resolve_replays")
    finally:
        profiling.reset()
    return got, replays, cache


def _assert_same_resolves(got, want):
    for k, ((f, cg), (f0, cg0)) in enumerate(zip(got, want)):
        for a, b in ((f, f0), (cg.p[0], cg0.p[0]), (cg.r_prev[0], cg0.r_prev[0]),
                     (cg.rho, cg0.rho), (cg.have_p, cg0.have_p),
                     (cg.step_alpha, cg0.step_alpha)):
            assert torch.equal(a, b), (k, float((a.float() - b.float()).abs().max()))


@pytest.mark.parametrize("n,size", [(1, "small"), (3, "small"), (3, "eval")])
def test_graphed_resolve_equals_the_eager_one(gen, monkeypatch, n, size):
    """The re-solve replayed as a CUDA graph against the same calls run
    eagerly (a cache of size 0), bit for bit: the filter and the CG state
    after each of three resolve_due calls of two sequences whose memories
    are separate allocations, the due masks alternating (a graph output fed
    back without a copy would be overwritten by the next replay before it is
    read), and after filter_resolve. The key's first call runs eagerly, every
    later one replays: 5 of the 6 resolve_due calls count a replay, and the
    cache holds one graph."""
    want, eager_replays, _ = _resolve_runs(monkeypatch, 0, n, size)
    got, replays, cache = _resolve_runs(monkeypatch, 4, n, size)
    assert eager_replays == 0 and replays == 5
    assert len(cache) == cache.captured() == 1
    _assert_same_resolves(got, want)


@pytest.mark.parametrize("shapes", ["shared", "apart"])
def test_graphed_resolve_of_two_layers(gen, monkeypatch, shapes):
    """Two target-model layers of three objects (ml_disc_init), re-solved one
    after the other as the fused tracker does, over three windows, graphed
    against eager bit for bit. Layers of one shape share one graph, so a
    layer's filter that aliased the graph's output would be overwritten by
    the next layer's replay; layers of two shapes take a graph each."""
    from frtm_tpu_torch.config import DiscConfig
    from frtm_tpu_torch.models import discriminator as td
    from frtm_tpu_torch.models.multilayer import ml_disc_init
    from frtm_tpu_torch.utils.cuda_graphs import GraphCache
    n, K, H, W = 3, 3, 48, 64
    hw = {"layer4": (6, 8), "layer3": (6, 8) if shapes == "shared" else (12, 16)}
    cfgs = {L: DiscConfig(in_channels=16, c_channels=8, init_iters=(2, 3), update_iters=(3,),
                          memory_size=6, train_skipping=1, layer=L) for L in hw}

    def run(maxsize):
        cache = GraphCache(maxsize)
        monkeypatch.setattr(td, "RESOLVE_GRAPHS", cache)
        g = torch.Generator().manual_seed(5)
        feats = {L: torch.randn((n, K, 16, *s), generator=g).cuda() for L, s in hw.items()}
        masks = torch.zeros((n, K, 1, H, W))
        for i in range(n):
            masks[i, :, :, 10 + 3 * i:34, 14:44 - 4 * i] = 1.0
        p0 = {L: td.repeat_params(td.init_disc_params(c, g, "cuda"), n) for L, c in cfgs.items()}
        params, states = ml_disc_init(p0, feats, masks.cuda(), cfgs)
        out = []
        for step in range(3):
            due = torch.tensor([(k + step) % 2 == 0 for k in range(n)], device="cuda")
            for L in cfgs:
                c = torch.randn((n, 8, *hw[L]), generator=g).cuda()
                y = masks[:, step % K].cuda()
                td.insert_sample(states[L], c, y, torch.ones(n, dtype=torch.bool, device="cuda"),
                                 [True] * n, cfgs[L])
            for L in cfgs:
                params[L] = td.resolve_due(params[L], states[L], due, cfgs[L])
            out += [(params[L].filter, states[L].cg) for L in cfgs]
        torch.cuda.synchronize()
        return out, cache
    want, _ = run(0)
    got, cache = run(8)
    assert cache.captured() == (1 if shapes == "shared" else 2)
    _assert_same_resolves(got, want)


def test_fused_tracker_replays_its_resolves_bit_equal(gen, monkeypatch):
    """The fused tracker on the card, three two-object sequences of 9 frames
    (windows of 2: 4 re-solves each), with the graphs and with every init
    and re-solve eager: the same labels and final filters bit for bit; the
    first re-solve runs eagerly and the other 11 replay, the first init runs
    eagerly and the other two replay."""
    from frtm_tpu_torch.data.synthetic import make_moving_square_sequence
    from frtm_tpu_torch.models import discriminator as td
    from frtm_tpu_torch.utils import profiling
    from frtm_tpu_torch.utils.cuda_graphs import GraphCache
    tracker = _small_fused_world()
    seqs = [make_moving_square_sequence(n_frames=9, size=(96, 128), square=24, n_objects=2,
                                        seed=20 + i) for i in range(3)]
    runs = []
    for maxsize in (0, 4):
        monkeypatch.setattr(td, "RESOLVE_GRAPHS", GraphCache(maxsize))
        monkeypatch.setattr(td, "INIT_GRAPHS", GraphCache(maxsize))
        profiling.reset()
        try:
            with profiling.recording():
                outs = [(tracker.run_sequence(s)[0], tracker.last_models[0].filter.clone())
                        for s in seqs]
            counts = profiling.counts()
        finally:
            profiling.reset()
        runs.append((outs, counts))
    (eager, eager_counts), (graphed, counts) = runs
    assert eager_counts == {"resolves": 12, "resolve_replays": 0, "inits": 3, "init_replays": 0}
    assert counts == {"resolves": 12, "resolve_replays": 11, "inits": 3, "init_replays": 2}
    for (labels0, f0), (labels, f) in zip(eager, graphed):
        assert all(a.tobytes() == b.tobytes() for a, b in zip(labels0, labels))
        assert torch.equal(f0, f)


def _init_problem(n, size, seed):
    """An init's inputs on the card from seeded features and boxes: (cfg,
    starting weights of n lanes, (n, K, Cin, h, w) features, (n, K, 1, H, W)
    uint8 masks as the fused tracker hands them over), at the CPU tests'
    size (32 channels into 8, K = 3, 6x8 scores, 24x32 masks, a memory of 8)
    or the eval configuration's (1024 into 96, K = 6, 30x54, 480x854, a
    memory of 80, init_iters (5, 10, 10, 10, 10), update_iters (10,))."""
    from frtm_tpu_torch.config import DiscConfig, eval_config
    from frtm_tpu_torch.models import discriminator as td
    cfg = (DiscConfig(in_channels=32, c_channels=8, init_iters=(3, 5), update_iters=(3,),
                      memory_size=8, train_skipping=2) if size == "small"
           else eval_config("resnet101").disc)
    K, h, w, H, W = (3, 6, 8, 24, 32) if size == "small" else (6, 30, 54, 480, 854)
    g = torch.Generator().manual_seed(seed)
    labels = torch.zeros((n, K, 1, H, W), dtype=torch.uint8)
    for i in range(n):
        for k in range(K):
            y = int(torch.randint(0, H - H // 3, (1,), generator=g))
            x = int(torch.randint(0, W - W // 3, (1,), generator=g))
            labels[i, k, 0, y:y + H // 3, x:x + W // 3] = 1
    feats = torch.randn((n, K, cfg.in_channels, h, w), generator=g).cuda()
    p0 = td.init_disc_params(cfg, g, "cuda")
    return cfg, td.repeat_params(p0, n), feats, labels.cuda()


def _init_tensors(params, state):
    m, cg = state.memory, state.cg
    return (params.project, params.filter, m.samples, m.labels, m.pixel_weights, m.weights,
            m.current_size, m.prev_ind, *cg.p, *cg.r_prev, cg.rho, cg.have_p, cg.step_alpha,
            state.n_resolves)


@pytest.mark.parametrize("n,size", [(1, "eval"), (2, "eval"), (5, "eval"), (3, "small")])
def test_graphed_init_equals_the_eager_one(gen, monkeypatch, n, size):
    """Three inits of one key through disc_init_graphed (eager, capture,
    replay), each on its own seeded problem, against disc_init of the same
    problem, bit for bit: projection, filter, the memory's six buffers, the
    CG state. Then on the replayed init's result a frame's insert and a
    resolve_due give the filter and CG state of the all-eager path (every
    graph cache of size 0). Prints the memory that the key's graph holds."""
    from frtm_tpu_torch.models import discriminator as td
    from frtm_tpu_torch.utils import profiling
    from frtm_tpu_torch.utils.cuda_graphs import GraphCache
    problems = [_init_problem(n, size, seed=30 + s) for s in range(3)]
    monkeypatch.setattr(td, "INIT_GRAPHS", GraphCache(0))
    monkeypatch.setattr(td, "RESOLVE_GRAPHS", GraphCache(0))
    with torch.no_grad():
        want = [td.disc_init(*p[1:], p[0]) for p in problems]
    want_tensors = [tuple(t.clone() for t in _init_tensors(*m)) for m in want]
    cache = GraphCache(4)
    monkeypatch.setattr(td, "INIT_GRAPHS", cache)
    got = []
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    profiling.reset()
    try:
        with torch.no_grad(), profiling.recording():
            for p in problems:
                got.append(td.disc_init_graphed(*p[1:], p[0]))
        counts = profiling.counts()
    finally:
        profiling.reset()
    torch.cuda.synchronize()
    print(f"init graph of {n} lanes ({size}): {(torch.cuda.memory_reserved() - reserved) / 1e9:.3f}"
          " GB more reserved over the three calls")
    assert counts == {"inits": 3, "init_replays": 2} and cache.captured() == 1
    for k, (models, ref) in enumerate(zip(got, want_tensors)):
        assert models[1].frame_num == [0] * n
        for j, (a, b) in enumerate(zip(_init_tensors(*models), ref)):
            assert a.dtype == b.dtype and torch.equal(a, b), (k, j)

    cfg = problems[2][0]
    h, w = problems[2][2].shape[-2:]
    H, W = problems[2][3].shape[-2:]
    g = torch.Generator().manual_seed(40)
    c = torch.randn((n, cfg.c_channels, h, w), generator=g).cuda()
    y = (torch.rand((n, 1, H, W), generator=g) > 0.7).float().cuda()
    due = torch.tensor([k % 2 == 0 for k in range(n)], device="cuda")
    on = torch.ones(n, dtype=torch.bool, device="cuda")
    followed = []
    for models, graphs in ((want[2], 0), (got[2], 4)):
        monkeypatch.setattr(td, "RESOLVE_GRAPHS", GraphCache(graphs))
        params, state = models
        with torch.no_grad():
            td.insert_sample(state, c, y, on, [True] * n, cfg)
            params = td.resolve_due(params, state, due, cfg)
        followed.append((params.filter, state.cg))
    _assert_same_resolves(followed[1:], followed[:1])
