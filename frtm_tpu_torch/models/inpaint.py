"""Host image operations that first-frame augmentation needs without cv2:
the 2x2-ellipse dilation and Telea's fast-marching inpainting, both as
OpenCV computes them (photo/src/inpaint.cpp, `cv::inpaint(..., INPAINT_TELEA)`
on 8-bit 3-channel images).

`inpaint_telea` and `dilate_ellipse2` run in the port's host library
(utils/csrc/frtm_host.cpp, through utils/native.py), which repeats the
algorithm below step by step, bit for bit. The Python versions below,
`inpaint_telea_plain` and `dilate_ellipse2_plain`, are the plain versions the
tests hold the library against.

Telea follows OpenCV step by step: a one-pixel KNOWN border around the
image; the narrow band = cross-dilated hole minus the hole; an outward
fast-marching pass over the ring of width `radius` that gives the known
side negative arrival times; then the inward pass, filling each hole pixel
from its known neighbours within `radius`, weighted by direction, distance
and level-set difference, with OpenCV's image-gradient terms. OpenCV keeps
its narrow band in a sorted list where equal times leave in arrival order;
a heap keyed by (time, arrival number) pops in the same order. Arithmetic is
float32 where OpenCV's is `float` and float64 where it is `double`: the
arrival-time solve, the distance weight, and the level-set weight
1 / (1 + |dt|), whose `fabs` promotes the float32 time difference to double
so that the sum and the quotient are double (rounded to float32 once). The
rest of the fill (direction, weights, sums) is float32.
"""
import heapq

import numpy as np

from ..utils.native import dilate_ellipse2, inpaint_telea  # noqa: F401 (the module's API)

KNOWN, BAND, INSIDE, CHANGE = 0, 1, 2, 3
f32 = np.float32


def dilate_ellipse2_plain(mask: np.ndarray) -> np.ndarray:
    """cv2.dilate(mask, getStructuringElement(MORPH_ELLIPSE, (2, 2))): the
    element is [[0, 1], [1, 1]] anchored at (1, 1), so a pixel takes the
    max of itself, its left and its upper neighbour."""
    out = mask.copy()
    out[:, 1:] = np.maximum(out[:, 1:], mask[:, :-1])
    out[1:, :] = np.maximum(out[1:, :], mask[:-1, :])
    return out


def _dilate(img: np.ndarray, r: int, cross: bool) -> np.ndarray:
    """Max over a (2r+1)^2 square (or a radius-1 cross) neighbourhood."""
    H, W = img.shape
    p = np.zeros((H + 2 * r, W + 2 * r), img.dtype)
    p[r:r + H, r:r + W] = img
    out = img.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if cross and dy and dx:
                continue
            np.maximum(out, p[r + dy:r + dy + H, r + dx:r + dx + W], out=out)
    return out


def _solve(f, t, i1, j1, i2, j2):
    """OpenCV's FastMarching_solve, in double, returned as float32."""
    a11 = float(t[i1][j1])
    a22 = float(t[i2][j2])
    m12 = min(a11, a22)
    if f[i1][j1] != INSIDE:
        if f[i2][j2] != INSIDE:
            if abs(a11 - a22) >= 1.0:
                sol = 1.0 + m12
            else:
                sol = (a11 + a22 + np.sqrt(2.0 - (a11 - a22) * (a11 - a22))) * 0.5
        else:
            sol = 1.0 + a11
    elif f[i2][j2] != INSIDE:
        sol = 1.0 + a22
    else:
        sol = 1.0 + m12
    return f32(sol)


def _arrival(f, t, i, j):
    return min(_solve(f, t, i - 1, j, i, j - 1), _solve(f, t, i + 1, j, i, j - 1),
               _solve(f, t, i - 1, j, i, j + 1), _solve(f, t, i + 1, j, i, j + 1))


_NEIGHBOURS = ((-1, 0), (0, -1), (1, 0), (0, 1))


def _march_outward(f, t, seeds):
    """OpenCV icvCalcFMM with negate=true over the ring `f` (INSIDE = to do)."""
    heap = [(f32(0.0), n, i, j) for n, (i, j) in enumerate(seeds)]
    count = len(heap)
    rows, cols = len(f), len(f[0])
    while heap:
        _, _, ii, jj = heapq.heappop(heap)
        f[ii][jj] = CHANGE
        for di, dj in _NEIGHBOURS:
            i, j = ii + di, jj + dj
            if i <= 0 or j <= 0 or i > rows or j > cols:
                continue
            if f[i][j] == INSIDE:
                dist = _arrival(f, t, i, j)
                t[i][j] = dist
                f[i][j] = BAND
                heapq.heappush(heap, (dist, count, i, j))
                count += 1
    for i in range(rows):
        for j in range(cols):
            if f[i][j] == CHANGE:
                f[i][j] = KNOWN
                t[i][j] = -t[i][j]


def _grad_t(f, t, i, j):
    """gradT of OpenCV's Telea step (one-sided where a side is INSIDE)."""
    if f[i][j + 1] != INSIDE:
        gx = ((t[i][j + 1] - t[i][j - 1]) * f32(0.5) if f[i][j - 1] != INSIDE
              else t[i][j + 1] - t[i][j])
    else:
        gx = t[i][j] - t[i][j - 1] if f[i][j - 1] != INSIDE else f32(0.0)
    if f[i + 1][j] != INSIDE:
        gy = ((t[i + 1][j] - t[i - 1][j]) * f32(0.5) if f[i - 1][j] != INSIDE
              else t[i + 1][j] - t[i][j])
    else:
        gy = t[i][j] - t[i - 1][j] if f[i - 1][j] != INSIDE else f32(0.0)
    return gx, gy


def _fill(f, t, out, i, j, radius, gx, gy):
    """Telea's weighted estimate of hole pixel (i, j) (extended coords),
    written to `out` (H, W, 3) int32 in place."""
    rows, cols = len(f), len(f[0])
    tij = t[i][j]
    for color in range(3):
        Ia = Jx = Jy = f32(0.0)
        s = f32(1.0e-20)
        for k in range(i - radius, i + radius + 1):
            km = k - 1 + (k == 1)
            kp = k - 1 - (k == rows - 2)
            for l in range(j - radius, j + radius + 1):
                if not (0 < k < rows - 1 and 0 < l < cols - 1):
                    continue
                if f[k][l] == INSIDE or (l - j) ** 2 + (k - i) ** 2 > radius * radius:
                    continue
                lm = l - 1 + (l == 1)
                lp = l - 1 - (l == cols - 2)
                ry, rx = f32(i - k), f32(j - l)
                length = rx * rx + ry * ry
                dst = f32(1.0 / (float(length) * np.sqrt(float(length))))
                lev = f32(1.0 / (1.0 + abs(float(t[k][l] - tij))))
                direction = rx * gx + ry * gy
                if abs(float(direction)) <= 0.01:
                    direction = f32(0.000001)
                w = abs(dst * lev * direction)
                if f[k][l + 1] != INSIDE:
                    if f[k][l - 1] != INSIDE:
                        gix = f32(int(out[km][lp + 1][color]) - int(out[km][lm - 1][color])) * f32(2.0)
                    else:
                        gix = f32(int(out[km][lp + 1][color]) - int(out[km][lm][color]))
                else:
                    if f[k][l - 1] != INSIDE:
                        gix = f32(int(out[km][lp][color]) - int(out[km][lm - 1][color]))
                    else:
                        gix = f32(0.0)
                if f[k + 1][l] != INSIDE:
                    if f[k - 1][l] != INSIDE:
                        giy = f32(int(out[kp + 1][lm][color]) - int(out[km - 1][lm][color])) * f32(2.0)
                    else:
                        giy = f32(int(out[kp + 1][lm][color]) - int(out[km][lm][color]))
                else:
                    if f[k - 1][l] != INSIDE:
                        giy = f32(int(out[kp][lm][color]) - int(out[km - 1][lm][color]))
                    else:
                        giy = f32(0.0)
                Ia = Ia + w * f32(out[k - 1][l - 1][color])
                Jx = Jx - w * (gix * rx)
                Jy = Jy - w * (giy * ry)
                s = s + w
        sat = Ia / s + (Jx + Jy) / (np.sqrt(Jx * Jx + Jy * Jy) + f32(1.0e-20)) + f32(0.5)
        out[i - 1][j - 1][color] = min(max(int(np.rint(sat)), 0), 255)


def inpaint_telea_plain(image: np.ndarray, mask: np.ndarray, radius: int) -> np.ndarray:
    """cv2.inpaint(image, mask, radius, cv2.INPAINT_TELEA) for (H, W, 3)
    uint8 images; `mask` nonzero marks the hole."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("inpaint_telea takes (H, W, 3) uint8 images")
    radius = min(max(int(round(radius)), 1), 100)
    H, W = image.shape[:2]
    hole = np.zeros((H + 2, W + 2), np.uint8)
    hole[1:-1, 1:-1][np.asarray(mask).reshape(H, W) != 0] = INSIDE
    if not hole.any():
        return image.copy()

    band = _dilate(hole, 1, cross=True) - hole
    band[[0, -1], :] = 0
    band[:, [0, -1]] = 0
    seeds = list(zip(*np.nonzero(band)))          # raster order, as OpenCV adds them

    f = np.full((H + 2, W + 2), KNOWN, np.uint8)
    f[band != 0] = BAND
    f[hole != 0] = INSIDE
    t = np.full((H + 2, W + 2), 1.0e6, np.float32)
    t[band != 0] = 0.0

    ring = _dilate(hole, radius, cross=False) - hole
    ring = np.where(band != 0, 0, ring).astype(np.uint8)
    ring[[0, -1], :] = 0
    ring[:, [0, -1]] = 0

    # Python lists of numpy float32 scalars: element access on lists is ~5x
    # faster than on arrays, and float32 scalars keep OpenCV's float rounding
    f_l, t_l = f.tolist(), [list(row) for row in t]
    ring_l = ring.tolist()
    _march_outward(ring_l, t_l, seeds)

    out = image.astype(np.int32).tolist()
    heap = [(f32(0.0), n, i, j) for n, (i, j) in enumerate(seeds)]
    count = len(heap)
    rows, cols = H + 2, W + 2
    while heap:
        _, _, ii, jj = heapq.heappop(heap)
        f_l[ii][jj] = KNOWN
        for di, dj in _NEIGHBOURS:
            i, j = ii + di, jj + dj
            if i <= 0 or j <= 0 or i > rows - 1 or j > cols - 1:
                continue
            if f_l[i][j] != INSIDE:
                continue
            dist = _arrival(f_l, t_l, i, j)
            t_l[i][j] = dist
            gx, gy = _grad_t(f_l, t_l, i, j)
            _fill(f_l, t_l, out, i, j, radius, gx, gy)
            f_l[i][j] = BAND
            heapq.heappush(heap, (dist, count, i, j))
            count += 1
    return np.asarray(out, np.uint8)

