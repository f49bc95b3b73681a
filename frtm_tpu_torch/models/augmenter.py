"""First-frame augmentation (frtm_tpu/models/augmenter.py): cut the target
out, inpaint the hole, and paste the target back under random affine and
blur transforms to build the target model's initial training set.

The spec and accept sequence comes from the caller's np.random.RandomState
exactly as in the JAX augmenter. Cutting and Telea inpainting run on the host
(models/inpaint.py, no cv2); every warp runs through kernel 3
(ops/kernels/warp_affine.py) on the augmenter's device — the background
warp, and the foreground's RGBA target (bicubic) and label (nearest) in one
mixed launch under their common map — the blur filters are
zero-border per-channel correlations there, their taps summed in the order of
frtm_tpu's CPU convolution (correlate_planes), and the batch is composed
there.
"""
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.kernels import warp_affine
from .inpaint import dilate_ellipse2, inpaint_telea

_DEFAULT_SELECTIONS = dict(
    num_aug=20,
    location=[(0.5, 0.5)],
    rotation=[5, -5, 10, -10, 20, -20, 30, -30, 45, -45, 60, -60],
    fliplr=[False, False, True],
    scale=[0.7, 1.0, 1.5, 2.0, "0.25", "0.5", "1.0"],
    skew=[(0.0, 0.0), (0.0, 0.0), (0.1, 0.1)],
    blur_size=[0.0, 0.0, 0.0, 2.0, 5.0],
    blur_angle=[0, 45, 90, 135],
)


@dataclass
class AugSpec:
    """One augmentation: target centre (image fractions), rotation (deg),
    mirror, scale (number = factor, str = fraction of image height), skew,
    blur size / angle."""
    location: tuple
    rotation: float = 0.0
    fliplr: bool = False
    scale: object = 1.0
    skew: tuple = (0.0, 0.0)
    blur_size: float = 0.0
    blur_angle: float = 0.0
    min_size: int = 10


def _translate(dx, dy):
    return np.array([[1, 0, dx], [0, 1, dy], [0, 0, 1]], np.float64)


def _rotate(a):
    ca, sa = np.cos(a), np.sin(a)
    return np.array([[ca, sa, 0], [-sa, ca, 0], [0, 0, 1]], np.float64)


def _scale_m(sx, sy):
    return np.diag([sx, sy, 1.0])


def _skew_m(kx, ky):
    return np.array([[1, kx, 0], [ky, 1, 0], [0, 0, 1]], np.float64)


def blur_kernel(sx, sy, R):
    """Rotated anisotropic Gaussian."""
    cov = R @ np.diag((sx, sy)) @ R.T
    s = int(np.max((sx, sy)) / 2 + 0.5)
    s = s + (s + 1) % 2
    r = np.arange(-s, s + 1)
    X = np.stack(np.meshgrid(r, r))
    X = (X * np.tensordot(np.linalg.inv(cov), X, axes=[1, 0])).sum(0)
    G = np.exp(-0.5 * X)
    return (G / G.sum()).astype(np.float32)


def correlate_planes(planes: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Zero-border correlation of (C, H, W) float32 planes with a (k, k)
    float32 kernel, k odd, its k * k row-major taps summed in the order of
    the XLA CPU convolution that frtm_tpu's augmenter calls (read off it
    with cancelling probe values), so that every value equals it: tap t's
    product starts lane t % 8 for t < 8, and each later tap of a whole group
    of eight is a fused multiply-add into its lane; the lanes are summed as
    ((0 + 1) + (4 + 5)) + ((2 + 3) + (6 + 7)), and the last tap
    (k * k = 1 mod 8) is added as a rounded product. Measured equal for the
    3 x 3 and 7 x 7 kernels that the blur sizes make; larger kernels take
    another order there. A blurred flat region shows the difference: summed
    in another order, its values fall a float32 step below the integer, and
    their uint8 cast one count.

    The multiply-add is exact in float64 (the product of two float32s is),
    rounded there and again to float32: one rounding, as fused, unless the
    float64 sum falls exactly halfway between two float32 values."""
    kh, kw = kernel.shape
    _, H, W = planes.shape
    x = F.pad(planes, (kw // 2, kw // 2, kh // 2, kh // 2))
    taps = [x[:, i:i + H, j:j + W] for i in range(kh) for j in range(kw)]
    w = torch.from_numpy(np.ascontiguousarray(kernel, np.float32).reshape(-1, 1, 1, 1))
    w, w64 = w.to(planes.device), w.double().to(planes.device)
    n = len(taps) - 1
    lanes = torch.stack(taps[:8]) * w[:8]
    for t in range(8, n, 8):        # a group of eight at a time: no k * k copy
        lanes = torch.addcmul(lanes.double(), torch.stack(taps[t:t + 8]).double(),
                              w64[t:t + 8]).float()
    pairs = lanes[0::2] + lanes[1::2]               # (0 + 1), (2 + 3), (4 + 5), (6 + 7)
    halves = pairs[:2] + pairs[2:]
    return (halves[0] + halves[1]) + taps[n] * w[n]


def center_bbox_from_mask(mask) -> tuple:
    """(center_x, center_y, w, h) of the nonzero extent; w = h = 0 when empty."""
    mask = np.asarray(mask).squeeze()
    ys = np.flatnonzero(mask.sum(axis=-1))
    xs = np.flatnonzero(mask.sum(axis=-2))
    if len(ys) == 0 or len(xs) == 0:
        return 0.0, 0.0, 0, 0
    w = xs[-1] - xs[0] + 1
    h = ys[-1] - ys[0] + 1
    return xs[0] + w / 2, ys[0] + h / 2, w, h


def cut_and_inpaint(image, mask):
    """The target cut out (alpha = the mask) and the TELEA-inpainted
    background, as the JAX augmenter computes them with d = 1, f = 1: the
    hole is the mask dilated by the 2x2 ellipse, inpainted with radius 1 on a
    sub-window with a margin of 5 around it (bit-identical to the full frame).

    :return: (target RGBA (H, W, 4) float32 in 0..255, inpainted (H, W, 3) uint8)
    """
    image = np.asarray(image, np.uint8)
    mask = (np.asarray(mask).squeeze() > 0).astype(np.uint8)
    target = np.concatenate((mask[..., None] * image, (mask * 255)[..., None]), axis=-1)
    hole = dilate_ellipse2(mask)
    ys = np.flatnonzero(hole.any(axis=1))
    xs = np.flatnonzero(hole.any(axis=0))
    inpainted = image.copy()
    if len(ys):
        H, W = hole.shape
        m = 5
        y0, y1 = max(0, ys[0] - m), min(H, ys[-1] + 1 + m)
        x0, x1 = max(0, xs[0] - m), min(W, xs[-1] + 1 + m)
        inpainted[y0:y1, x0:x1] = inpaint_telea(image[y0:y1, x0:x1], hole[y0:y1, x0:x1], 1)
    return target.astype(np.float32), inpainted


class ImageAugmenter:

    def __init__(self, params: dict, device=None):
        """:param params: dict with num_aug, min_px_count, fg_aug_params and
        optional bg_aug_params (parameter-selection lists)"""
        self.params = params
        self.device = resolve_device(device)
        self.max_retries = 100

    # -- spec generation ----------------------------------------------------

    def generate_target_locations(self, N, im_size, rng):
        """Jittered shuffled grid of target centres."""
        h, w = im_size
        aspect = w / h
        nrows = int(np.ceil(np.sqrt(N / aspect)))
        ncols = int(np.ceil(aspect * nrows))
        co_max, ro_max = 0.5 / ncols, 0.5 / nrows
        centers = []
        for r in range(nrows):
            for c in range(ncols):
                x = (c + 0.5) / ncols + rng.normal(0, co_max / 4)
                y = (r + 0.5) / nrows + rng.normal(0, ro_max / 4)
                centers.append((round(x, 3), round(y, 3)))
        rng.shuffle(centers)
        return centers[:N]

    def generate_specs(self, selections: dict, rng):
        """Independently shuffle each parameter list and zip into num_aug - 1
        specs (num_aug defaults to 20: over-generated, cropped later)."""
        sel = dict(_DEFAULT_SELECTIONS)
        sel.update(selections)
        N = sel.pop("num_aug") - 1
        chosen = {}
        for k, vals in sel.items():
            vals = list(vals) * ((N + len(vals) - 1) // len(vals))
            rng.shuffle(vals)
            chosen[k] = vals[:N]
        return [AugSpec(**{k: chosen[k][i] for k in chosen}) for i in range(N)]

    def get_transform(self, spec: AugSpec, tg_bbox, im_size, limit_scale=True):
        """Affine 3x3 + blur kernel from a spec."""
        tg_x, tg_y, tg_w, tg_h = tg_bbox
        assert tg_w > 0 and tg_h > 0
        im_h, im_w = im_size
        t, a, s, k = spec.location, spec.rotation, spec.scale, spec.skew
        if isinstance(s, str):
            s = float(s) * im_h / tg_h
        if limit_scale:
            if s * tg_w > im_w or s * tg_h > im_h:
                s = min(im_w / tg_w, im_h / tg_h)
            if s * tg_w < spec.min_size or s * tg_h < spec.min_size:
                s = max(spec.min_size / tg_w, spec.min_size / tg_h)
        m = -1 if spec.fliplr else 1
        d2r = np.pi / 180
        T = (_translate(t[0] * im_w, t[1] * im_h) @ _skew_m(*k)
             @ _rotate(a * d2r) @ _scale_m(m * s, s) @ _translate(-tg_x, -tg_y))
        if spec.blur_size > 0:
            G = blur_kernel(spec.blur_size, 0.1, _rotate(spec.blur_angle * d2r)[:2, :2])
        else:
            G = np.array([[1.0]], np.float32)
        return T, G

    # -- device warp / filter ------------------------------------------------

    def _filter(self, planes: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
        """Zero-border per-channel correlation of (C, H, W) planes."""
        if kernel.shape == (1, 1):
            return planes
        return correlate_planes(planes, kernel)

    def _paste_bbox(self, target_lbl, T, G, src_bbox, im_size):
        """Warped, blurred target patch restricted to its transformed bbox:
        (None, box, None) when it lands fully off-frame, else (RGBA patch
        (4, h, w) float32, (y0, y1, x0, x1), label patch (1, h, w) float32).
        target_lbl: the RGBA target and the label, (5, H, W) float32; one
        warp samples the first four planes bicubic and the label nearest."""
        H, W = im_size
        cx, cy, bw, bh = src_bbox
        margin = 3 + G.shape[0] // 2
        corners = np.array([[cx - bw / 2, cy - bh / 2, 1], [cx + bw / 2, cy - bh / 2, 1],
                            [cx - bw / 2, cy + bh / 2, 1], [cx + bw / 2, cy + bh / 2, 1]]).T
        tc = np.asarray(T) @ corners
        tc = tc[:2] / tc[2]
        x0 = max(0, int(np.floor(tc[0].min())) - margin)
        x1 = min(W, int(np.ceil(tc[0].max())) + margin + 1)
        y0 = max(0, int(np.floor(tc[1].min())) - margin)
        y1 = min(H, int(np.ceil(tc[1].max())) + margin + 1)
        if x0 >= x1 or y0 >= y1:
            return None, (y0, y1, x0, x1), None
        Ts = _translate(-x0, -y0) @ np.asarray(T)
        sub = (y1 - y0, x1 - x0)
        both = warp_affine(target_lbl, Ts, sub, "bicubic", nearest_from=4)
        return self._filter(both[:4].clamp(0, 255), G), (y0, y1, x0, x1), both[4:]

    # -- top level ----------------------------------------------------------

    @torch.no_grad()
    def augment_first_frame(self, image, mask, rng: np.random.RandomState):
        """num_aug augmented (image, label) pairs; slot 0 is the real frame.

        :param image: (H, W, 3) uint8-range array
        :param mask:  (H, W, 1) binary object mask
        :return: (images (K, 3, H, W) uint8, labels (K, 1, H, W) uint8) on
                 the augmenter's device
        """
        p = self.params
        dev = self.device
        image = np.asarray(image)
        mask = np.asarray(mask).reshape(*image.shape[:2], 1)
        H, W = im_sz = image.shape[:2]

        px_count = int(mask.sum())
        no_background = px_count == mask.size
        if px_count < p["min_px_count"]:
            raise ValueError("Augmentation failed: Target object is too small.")
        tg_bbox = center_bbox_from_mask(mask)
        if tg_bbox[2] == 0 or tg_bbox[3] == 0:
            raise ValueError("Augmentation failed: No object to augment.")

        target, inpainted = cut_and_inpaint(image, mask)
        target = torch.from_numpy(np.ascontiguousarray(target.transpose(2, 0, 1))).to(dev)
        labels = torch.from_numpy(np.ascontiguousarray(
            np.asarray(mask, np.float32).transpose(2, 0, 1))).to(dev)
        inpainted = torch.from_numpy(np.ascontiguousarray(inpainted.transpose(2, 0, 1))).to(dev)
        target_lbl = torch.cat([target, labels])

        fg_sel = dict(p["fg_aug_params"])
        fg_sel["location"] = self.generate_target_locations(p["num_aug"], im_sz, rng)
        bg_sel = p.get("bg_aug_params")

        K = p["num_aug"]
        out_im = torch.empty((K, 3, H, W), dtype=torch.uint8, device=dev)
        out_lb = torch.zeros((K, 1, H, W), dtype=torch.uint8, device=dev)
        out_im[0] = torch.from_numpy(np.ascontiguousarray(image.transpose(2, 0, 1))).to(dev)
        out_lb[0] = labels.to(torch.uint8)

        # backgrounds are deterministic per spec: memoise (f32, uint8) per
        # spec (f32 None: the inpainted frame itself), and the warp per
        # distinct transform
        bg_cache, warp_cache = {}, {}

        def bg_for(bg_spec):
            if bg_spec is None:
                return None, inpainted
            key = (tuple(bg_spec.location), bg_spec.rotation, bg_spec.fliplr,
                   bg_spec.scale, tuple(bg_spec.skew), bg_spec.blur_size, bg_spec.blur_angle)
            if key not in bg_cache:
                T, G = self.get_transform(bg_spec, (W / 2, H / 2, W, H), im_sz,
                                          limit_scale=False)
                ident_T = np.allclose(T, np.eye(3), atol=1e-12)
                if ident_T and G.shape == (1, 1):
                    bg_cache[key] = (None, inpainted)
                else:
                    if ident_T:
                        base = inpainted.float()
                    else:
                        tkey = T.tobytes()
                        if tkey not in warp_cache:
                            warp_cache[tkey] = warp_affine(inpainted.float(), T, im_sz,
                                                           "bicubic").clamp(0, 255)
                        base = warp_cache[tkey]
                    f32 = self._filter(base, G)
                    bg_cache[key] = (f32, f32.to(torch.uint8))
            return bg_cache[key]

        min_px = p["min_px_count"]
        max_px = H * W - min_px
        N = K - 1
        n_good = 0
        retries = -1
        while n_good < N:
            retries += 1
            if retries > self.max_retries:
                raise RuntimeError("Augmentation failed: Not enough samples after %d retries."
                                   % self.max_retries)
            fg_specs = self.generate_specs(fg_sel, rng)
            bg_specs = (self.generate_specs(bg_sel, rng) if bg_sel is not None
                        else [None] * len(fg_specs))
            # lazily evaluate the exchangeable specs, stopping at N good ones
            for fg_spec, bg_spec in zip(fg_specs, bg_specs):
                if n_good >= N:
                    break
                bg_f32, bg_u8 = bg_for(bg_spec)
                T, G = self.get_transform(fg_spec, tg_bbox, im_sz)
                tgt, (y0, y1, x0, x1), lbl = self._paste_bbox(target_lbl, T, G, tg_bbox,
                                                              im_sz)
                if tgt is not None:
                    lbl_u8 = lbl.to(torch.uint8)
                    px = int((lbl_u8 == 1).sum())
                else:
                    px = 0
                if not (px >= min_px and (px < max_px or no_background)):
                    continue
                k = n_good + 1
                out_im[k] = bg_u8
                if tgt is not None:
                    alpha = tgt[3:4] / 255.0
                    bg_region = (bg_u8 if bg_f32 is None else bg_f32)[:, y0:y1, x0:x1].float()
                    patch = (tgt[:3] * alpha + bg_region * (1.0 - alpha)).clamp(0, 255)
                    out_im[k, :, y0:y1, x0:x1] = patch.to(torch.uint8)
                    out_lb[k, :, y0:y1, x0:x1] = lbl_u8
                # else accepted with no paste (only min_px_count == 0)
                n_good += 1
        return out_im, out_lb
