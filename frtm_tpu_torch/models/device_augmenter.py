"""First-frame augmentation with every spec of a round evaluated in one batch
on the augmenter's device (frtm_tpu/models/device_augmenter.py).

The semantics are the host augmenter's (models/augmenter.py): the same spec
stream from the caller's np.random.RandomState, the same transforms, the
same first-N-good selection. Cutting and Telea inpainting stay on the host
(once per object). Per retry round of S specs (generate_specs draws
`num_aug - 1` of them from the selections, 19 by default) the device runs:

  * one batched kernel-3 launch for the S backgrounds (bicubic, the
    inpainted frame), one for the S targets (bicubic, the bucketed RGBA
    crop under `fg_T`) and one for the S labels (nearest, the full mask
    under `fg_T_full`, as the JAX package warps it: `fg_T` and `fg_T_full`
    differ by a translation, so their float32 inverses differ in rounding,
    and a nearest tap at a .5 boundary would move if the label rode in the
    crop's launch);
  * the zero-border blurs, every spec's kernel embedded in (kmax, kmax), as
    kmax^2 shifted multiply-adds over (S, C, H, W) with per-spec weights (a
    grouped convolution would run as a loop over its groups on cuDNN);
  * the clamps, the alpha paste with `floor` and the visibility counts.

Then one host read of the S counts decides which specs are good. The number
of launches a round makes does not depend on S.

The JAX package's batch returns float32 frames; their values are integers in
0..255 after `floor` and `clip`, and labels are 0/1 after the nearest warp,
so the port returns them as uint8 (K, 3, H, W) images and (K, 1, H, W)
labels, slot 0 the real frame: the layout of the fused tracker's dense init.
The blur's summation order is not XLA's, so a value that lands within
rounding of an integer may floor one grey level apart from frtm_tpu's.
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels import warp_affine_batched
from .augmenter import ImageAugmenter, _translate, center_bbox_from_mask, cut_and_inpaint


def _embed_kernel(G, kmax):
    """Centre a (k, k) kernel in a (kmax, kmax) zero canvas (delta = identity)."""
    out = np.zeros((kmax, kmax), np.float32)
    k = G.shape[0]
    o = (kmax - k) // 2
    out[o:o + k, o:o + k] = G
    return out


def crop_box(tg_bbox, im_size, bucket):
    """(x0, y0, width, height) of the target's crop: its box with a margin of
    2, the size rounded up to a multiple of `bucket`, clipped at the frame;
    the JAX augmenter's integer arithmetic."""
    H, W = im_size
    cx, cy, bw, bh = tg_bbox
    x0 = max(0, int(cx - bw / 2) - 2)
    y0 = max(0, int(cy - bh / 2) - 2)
    cw = min(W - x0, -(-int(bw + 4) // bucket) * bucket)
    ch = min(H - y0, -(-int(bh + 4) // bucket) * bucket)
    return x0, y0, cw, ch


def _blur(planes: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Zero-border correlation of (S, C, H, W) planes, spec s with its own
    (k, k) kernel kernels[s]: k^2 shifted multiply-adds."""
    S, C, H, W = planes.shape
    k = kernels.shape[-1]
    r = k // 2
    padded = F.pad(planes, (r, r, r, r))
    w = kernels[:, None]
    out = torch.zeros_like(planes)
    for dy in range(k):
        for dx in range(k):
            out.addcmul_(padded[:, :, dy:dy + H, dx:dx + W], w[..., dy:dy + 1, dx:dx + 1])
    return out


def batch_augment(inpainted, target_crop, mask, fg_T, fg_T_full, fg_K, bg_T, bg_K, out_hw):
    """Evaluate S specs at once (frtm_tpu's `_batch_augment`).

    :param inpainted:   (3, H, W) uint8 background
    :param target_crop: (4, hc, wc) uint8 RGBA target cutout
    :param mask:        (1, H, W) uint8 binary target mask
    :param fg_T:        S forward matrices, crop coordinates -> output
    :param fg_T_full:   S forward matrices, frame coordinates -> output
    :param bg_T:        S background matrices
    :param fg_K, bg_K:  (S, kmax, kmax) float32 blur kernels on the device
    :return: images (S, 3, H, W) float32 (integers in 0..255), labels
             (S, 1, H, W) float32 0/1, foreground counts (S,)
    """
    wimage = warp_affine_batched(inpainted.float(), bg_T, out_hw, "bicubic").clamp_(0, 255)
    wimage = _blur(wimage, bg_K)
    tgt = warp_affine_batched(target_crop.float(), fg_T, out_hw, "bicubic").clamp_(0, 255)
    tgt = _blur(tgt, fg_K)
    lbl = warp_affine_batched(mask.float(), fg_T_full, out_hw, "nearest")
    alpha = tgt[:, 3:4] / 255.0
    # floor: the host path's uint8 truncation, so both backends quantise alike
    out = torch.floor((tgt[:, :3] * alpha + wimage * (1.0 - alpha)).clamp_(0, 255))
    return out, lbl, (lbl == 1).sum(dim=(1, 2, 3))


class DeviceAugmenter:
    """The augmenter of the fused tracker's `augment_backend="device"`: its
    augment_first_frame returns the batch on the device."""

    def __init__(self, params: dict, device=None, crop_bucket: int = 64):
        self.host = ImageAugmenter(params, device)
        self.params = params
        self.device = self.host.device
        self.crop_bucket = crop_bucket
        self.max_retries = self.host.max_retries
        self.last_rounds = 0

    def _kernel_max(self):
        """The side of the canvas every blur kernel is embedded in."""
        sizes = [0.0]
        for key in ("fg_aug_params", "bg_aug_params"):
            if key in self.params and self.params[key]:
                sizes += list(self.params[key].get("blur_size", [0.0]))
        s = int(max(sizes) / 2 + 0.5)
        s = s + (s + 1) % 2
        return max(1, 2 * s + 1)

    @torch.no_grad()
    def augment_first_frame(self, image, mask, rng: np.random.RandomState, image_dev=None):
        """num_aug augmented (image, label) pairs; slot 0 is the real frame.

        :param image: (H, W, 3) uint8-range array
        :param mask:  (H, W, 1) binary object mask
        :param image_dev: the frame's (H, W, 3) uint8 copy on the device, if
                 there is one (else it is uploaded)
        :return: (images (K, 3, H, W) uint8, labels (K, 1, H, W) uint8) on
                 the augmenter's device
        """
        p = self.params
        dev = self.device
        image = np.asarray(image)
        mask_np = np.asarray(mask).reshape(*image.shape[:2], 1).astype(np.float32)
        H, W = image.shape[:2]

        px_count = int(mask_np.sum())
        no_background = px_count == mask_np.size
        if px_count < p["min_px_count"]:
            raise ValueError("Augmentation failed: Target object is too small.")
        tg_bbox = center_bbox_from_mask(mask_np)
        if tg_bbox[2] == 0 or tg_bbox[3] == 0:
            raise ValueError("Augmentation failed: No object to augment.")

        target, inpainted = cut_and_inpaint(image, mask_np)
        x0, y0, cw, ch = crop_box(tg_bbox, (H, W), self.crop_bucket)
        target_crop = target[y0:y0 + ch, x0:x0 + cw].astype(np.uint8)

        kmax = self._kernel_max()
        fg_sel = dict(p["fg_aug_params"])
        fg_sel["location"] = self.host.generate_target_locations(p["num_aug"], (H, W), rng)
        bg_sel = p.get("bg_aug_params")

        def upload(a):
            return torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1))).to(dev)

        inp_dev, tgt_dev = upload(inpainted), upload(target_crop)
        msk_dev = upload(mask_np.astype(np.uint8))
        img_dev = upload(image.astype(np.uint8)) if image_dev is None \
            else image_dev.permute(2, 0, 1)

        N = p["num_aug"] - 1
        min_px = p["min_px_count"]
        max_px = H * W - min_px
        chosen_img, chosen_lbl = [], []
        n_good = 0
        retries = -1
        while n_good < N:
            retries += 1
            if retries > self.max_retries:
                raise RuntimeError("Augmentation failed: Not enough samples after %d retries."
                                   % self.max_retries)
            fg_specs = self.host.generate_specs(fg_sel, rng)
            bg_specs = (self.host.generate_specs(bg_sel, rng) if bg_sel is not None
                        else [None] * len(fg_specs))
            fg_T, fg_Tf, fg_K, bg_T, bg_K = [], [], [], [], []
            for fg_spec, bg_spec in zip(fg_specs, bg_specs):
                T, G = self.host.get_transform(fg_spec, tg_bbox, (H, W))
                fg_Tf.append(T)
                fg_T.append(T @ _translate(x0, y0))
                fg_K.append(_embed_kernel(G, kmax))
                if bg_spec is not None:
                    Tb, Gb = self.host.get_transform(bg_spec, (W / 2, H / 2, W, H), (H, W),
                                                     limit_scale=False)
                else:
                    Tb, Gb = np.eye(3), np.ones((1, 1), np.float32)
                bg_T.append(Tb)
                bg_K.append(_embed_kernel(Gb, kmax))

            imgs, lbls, counts = batch_augment(
                inp_dev, tgt_dev, msk_dev, fg_T, fg_Tf,
                torch.from_numpy(np.stack(fg_K)).to(dev), bg_T,
                torch.from_numpy(np.stack(bg_K)).to(dev), (H, W))
            counts = counts.cpu().numpy()       # the round's one host read
            good = (counts >= min_px) & ((counts < max_px) | no_background)
            idx = np.flatnonzero(good)[:N - n_good]
            if len(idx):
                sel = torch.from_numpy(idx).to(dev)
                chosen_img.append(imgs.index_select(0, sel))
                chosen_lbl.append(lbls.index_select(0, sel))
                n_good += len(idx)
        self.last_rounds = retries + 1
        images = torch.cat([img_dev[None], torch.cat(chosen_img).to(torch.uint8)])
        labels = torch.cat([msk_dev[None], torch.cat(chosen_lbl).to(torch.uint8)])
        return images, labels
