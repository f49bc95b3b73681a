"""cv2.resize for the training loaders, without cv2: uint8 (H, W, C) images
by area averaging (INTER_AREA) or bicubic interpolation (INTER_CUBIC), and
uint8 labels by nearest neighbour (INTER_NEAREST), each with OpenCV's
arithmetic. A resize to the same size returns a copy, as cv2 does.

`resize_area`, `resize_cubic` and `resize_nearest` run the port's host
library (utils/native.py, C++); the `*_plain` functions beside them are the
same arithmetic in numpy, which the tests hold the C++ to, value for value.

* Nearest: source index floor(x * (src / dst)) in double, clamped.
* Area (INTER_AREA), OpenCV's three paths, chosen as OpenCV chooses them from
  the scale factors src / dst (double):
  - both axes shrink (the loaders' case: YouTube-VOS 720x1280 to 480x854)
    by factors not both whole: the general path. Per axis a table of
    (destination, source, weight) entries, the weights float32 from double
    fractions of a cell; per source row the weighted columns summed in
    float32 in table order, the rows summed the same way, rounded half to
    even and saturated;
  - both factors whole numbers (resizeAreaFast; 960x1708 to 480x854): the
    integer sum of each cell, times the float32 1 / area, rounded half to
    even; at 2x2 with 1, 3 or 4 channels (sum + 2) >> 2;
  - an axis enlarges (a frame under 480x854): OpenCV's bilinear path with
    area weights on both axes. Per axis a source index floor(d * scale) and
    a fraction, both from (d + 1) - (s + 1) * dst / src, in 11-bit fixed
    point; the horizontal pass sums in integers, the vertical one as
    OpenCV's uint8 path does, ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >>
    16), plus 2, over 4.
* Cubic: OpenCV's weights, Keys cubic (A = -0.75) computed in float32 from
  the float32 source coordinate, the edge replicated; the two passes sum the
  four taps in float32, horizontal first, and round half to even. OpenCV's
  own uint8 path sums in a fixed point that is not reproduced here, so a
  value can land one grey level from cv2's where the exact sum lies within a
  few thousandths of a half (tests/test_torch_resize_host.py bounds the share
  of such values).
"""
import math

import numpy as np

from ..utils import native


def _check(image, size, what):
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"{what}: expected a uint8 (H, W) or (H, W, C) array, "
                         f"got {image.dtype} {image.shape}")
    dh, dw = size
    if dh <= 0 or dw <= 0 or 0 in image.shape[:2]:
        raise ValueError(f"{what}: cannot resize {image.shape[:2]} to {size}")
    return image


def _planes(image):
    """(H, W, C) view of a 2-D or 3-D image."""
    return image if image.ndim == 3 else image[..., None]


# -- nearest ----------------------------------------------------------------

def nearest_index(ssize, dsize):
    """OpenCV's resizeNN source index per destination index."""
    ifx = 1.0 / (dsize / ssize)
    return np.minimum(np.floor(np.arange(dsize) * ifx).astype(np.int64), ssize - 1)


def resize_nearest_plain(image, size):
    """cv2.resize(image, (W, H), interpolation=INTER_NEAREST); size = (H, W)."""
    image = _check(image, size, "resize_nearest")
    if image.shape[:2] == tuple(size):
        return image.copy()
    rows = nearest_index(image.shape[0], size[0])
    cols = nearest_index(image.shape[1], size[1])
    return np.ascontiguousarray(image[rows][:, cols])


# -- area -------------------------------------------------------------------

def area_scale(ssize, dsize):
    """OpenCV's scale factor of an axis: 1 / (dst / src) in double."""
    return 1.0 / (dsize / ssize)


def area_table(ssize, dsize, scale):
    """OpenCV's computeResizeAreaTab: (destination, source, float32 weight)
    entries in its order."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
    return tab


def area_path(src_hw, size):
    """OpenCV's choice of INTER_AREA path: ("general", (sy, sx)) with the
    double scale factors, ("fast", (iy, ix)) with the whole ones, or
    ("linear", None) where an axis enlarges."""
    sy, sx = area_scale(src_hw[0], size[0]), area_scale(src_hw[1], size[1])
    if sx < 1 or sy < 1:
        return "linear", None
    iy, ix = round(sy), round(sx)       # cvRound: half to even, as round()
    eps = np.finfo(np.float64).eps
    if abs(sx - ix) < eps and abs(sy - iy) < eps:
        return "fast", (iy, ix)
    return "general", (sy, sx)


def _padded(tab, dsize):
    """Table entries as (dsize, m) source and weight arrays, in table order
    per destination, padded with weight 0 (an exact no-op in the sums)."""
    n = np.zeros(dsize, np.int64)
    for d, _, _ in tab:
        n[d] += 1
    m = int(n.max())
    src = np.zeros((dsize, m), np.int64)
    wt = np.zeros((dsize, m), np.float32)
    k = np.zeros(dsize, np.int64)
    for d, s, a in tab:
        src[d, k[d]] = s
        wt[d, k[d]] = a
        k[d] += 1
    return src, wt


def resize_area_plain(image, size):
    """cv2.resize(image, (W, H), interpolation=INTER_AREA); size = (H, W)."""
    image = _check(image, size, "resize_area")
    if image.shape[:2] == tuple(size):
        return image.copy()
    path, factors = area_path(image.shape[:2], size)
    if path == "fast":
        out = _area_fast(_planes(image), size, *factors)
    elif path == "linear":
        out = _area_linear(_planes(image), size)
    else:
        out = _area_general(_planes(image), size, *factors)
    return out if image.ndim == 3 else out[..., 0]


def _area_general(planes, size, sy, sx):
    """The general path: both axes shrink, by factors not both whole."""
    src = planes.astype(np.float32)
    xs, xw = _padded(area_table(planes.shape[1], size[1], sx), size[1])
    ys, yw = _padded(area_table(planes.shape[0], size[0], sy), size[0])
    buf = np.zeros((src.shape[0], size[1], src.shape[2]), np.float32)
    for m in range(xs.shape[1]):
        buf = buf + src[:, xs[:, m]] * xw[:, m][None, :, None]
    acc = np.zeros((size[0], size[1], src.shape[2]), np.float32)
    for m in range(ys.shape[1]):
        acc = acc + yw[:, m][:, None, None] * buf[ys[:, m]]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def _area_fast(planes, size, iy, ix):
    """resizeAreaFast: whole factors iy, ix (size * factor is the source's)."""
    dh, dw = size
    s = np.zeros((dh, dw, planes.shape[2]), np.int64)
    for i in range(iy):
        for j in range(ix):
            s += planes[i:dh * iy:iy, j:dw * ix:ix]
    if iy == 2 and ix == 2 and planes.shape[2] in (1, 3, 4):
        return ((s + 2) >> 2).astype(np.uint8)
    scale = np.float32(1) / np.float32(iy * ix)
    return np.clip(np.rint(s.astype(np.float32) * scale), 0, 255).astype(np.uint8)


INTER_RESIZE_COEF_SCALE = np.float32(2048)     # OpenCV's 11-bit weights


def area_linear_table(ssize, dsize):
    """OpenCV's area-mode linear table of an axis: source index and the two
    fixed-point weights per destination index, before the edge rule."""
    inv = dsize / ssize
    scale = 1.0 / inv
    src = np.array([math.floor(d * scale) for d in range(dsize)], np.int64)
    fx = np.array([np.float32((d + 1) - (s + 1) * inv) for d, s in enumerate(src)], np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    w0 = np.rint((np.float32(1) - fx) * INTER_RESIZE_COEF_SCALE).astype(np.int64)
    w1 = np.rint(fx * INTER_RESIZE_COEF_SCALE).astype(np.int64)
    return src, w0, w1


def _area_linear(planes, size):
    """INTER_AREA where an axis enlarges: OpenCV's linear path with its area
    weights on both axes. A column whose index reaches the last source
    column takes it alone (weights 2048, 0); rows read the index and the
    next one, clamped to the last row."""
    H, W, _ = planes.shape
    src = planes.astype(np.int64)
    xs, a0, a1 = area_linear_table(W, size[1])
    edge = xs >= W - 1
    xs, a0, a1 = np.where(edge, W - 1, xs), np.where(edge, 2048, a0), np.where(edge, 0, a1)
    hbuf = src[:, xs] * a0[:, None] + src[:, np.minimum(xs + 1, W - 1)] * a1[:, None]
    ys, b0, b1 = area_linear_table(H, size[0])
    s0, s1 = hbuf[np.minimum(ys, H - 1)], hbuf[np.minimum(ys + 1, H - 1)]
    out = (((b0[:, None, None] * (s0 >> 4)) >> 16)
           + ((b1[:, None, None] * (s1 >> 4)) >> 16) + 2) >> 2
    return out.astype(np.uint8)


# -- cubic ------------------------------------------------------------------

def cubic_coeffs(f):
    """OpenCV's interpolateCubic in float32, for an array of fractions."""
    A = np.float32(-0.75)
    x = np.asarray(f, np.float32)
    one = np.float32(1)
    c0 = ((A * (x + one) - np.float32(5) * A) * (x + one) + np.float32(8) * A) * (x + one) \
        - np.float32(4) * A
    c1 = ((A + np.float32(2)) * x - (A + np.float32(3))) * x * x + one
    y = one - x
    c2 = ((A + np.float32(2)) * y - (A + np.float32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], -1)


def cubic_table(ssize, dsize):
    """(first source index (dsize,), (dsize, 4) float32 weights): OpenCV's
    source coordinate (d + 0.5) * scale - 0.5 in double, cast to float32."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, cubic_coeffs(f - s.astype(np.float32))


def resize_cubic_plain(image, size):
    """cv2.resize(image, (W, H), interpolation=INTER_CUBIC) on uint8, to
    within one grey level; size = (H, W)."""
    image = _check(image, size, "resize_cubic")
    if image.shape[:2] == tuple(size):
        return image.copy()
    src = _planes(image).astype(np.float32)
    H, W, C = src.shape
    sx, wx = cubic_table(W, size[1])
    sy, wy = cubic_table(H, size[0])
    cols = np.clip(sx[:, None] + np.arange(-1, 3), 0, W - 1)
    rows = np.clip(sy[:, None] + np.arange(-1, 3), 0, H - 1)
    taps = src[:, cols]                                      # (H, dw, 4, C)
    wxs = wx[None, :, :, None]
    hbuf = taps[:, :, 0] * wxs[:, :, 0]
    for k in range(1, 4):
        hbuf = hbuf + taps[:, :, k] * wxs[:, :, k]
    vt = hbuf[rows]                                          # (dh, 4, dw, C)
    wys = wy[:, :, None, None]
    acc = vt[:, 0] * wys[:, 0]
    for k in range(1, 4):
        acc = acc + vt[:, k] * wys[:, k]
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out if image.ndim == 3 else out[..., 0]


# -- the host library's versions ------------------------------------------------

def resize_nearest(image, size):
    """resize_nearest_plain, in C++."""
    image = _check(image, size, "resize_nearest")
    if image.shape[:2] == tuple(size):
        return image.copy()
    return native.resize_u8("nearest", _planes(image), size).reshape(
        tuple(size) + image.shape[2:])


def resize_area(image, size):
    """resize_area_plain, in C++."""
    image = _check(image, size, "resize_area")
    if image.shape[:2] == tuple(size):
        return image.copy()
    return native.resize_u8("area", _planes(image), size).reshape(tuple(size) + image.shape[2:])


def resize_cubic(image, size):
    """resize_cubic_plain, in C++."""
    image = _check(image, size, "resize_cubic")
    if image.shape[:2] == tuple(size):
        return image.copy()
    return native.resize_u8("cubic", _planes(image), size).reshape(tuple(size) + image.shape[2:])
