"""Composition of compact augment batches on the device
(frtm_tpu/models/aug_compose.py).

The augmenter's compact mode (`augment_first_frame(..., compact=True)`)
returns the pieces of one object's batch instead of K full frames: the
inpainted rectangle, at most one pre-blur warped background, and per slot a
blur kernel, a blended paste rectangle and a label rectangle. The port's
augmenter builds these on its device (every warp runs there), so nothing
here crosses to the host. `pack_compact_batch` stacks the pieces into
fixed-shape tensors and `compose_aug_batch` rebuilds the dense
(K, 3, H, W) / (K, 1, H, W) batch from them.

Exactness against the dense path, as for the JAX package (CompactAugBatch in
models/augmenter.py): bit-exact except for backgrounds that are warped and
then blurred, which differ by at most 1 uint8 count (the pre-blur base is
quantized to uint8).

Nothing is compiled per shape here, so rectangles are padded only as far
as stacking needs (to the largest of the batch): the JAX package's
64-pixel patch buckets, which bound its number of compiled programs, have
no counterpart. Boxes and background indices are host integers, so a paste
is a slice assignment over the valid rectangle.
"""
import numpy as np
import torch
import torch.nn.functional as F


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """np.packbits along the last axis (MSB first, zero-padded to a whole
    byte) of a 0/1 tensor, on the tensor's device."""
    w = bits.shape[-1]
    b = F.pad(bits.to(torch.uint8), (0, -w % 8))
    b = b.reshape(*b.shape[:-1], -1, 8).to(torch.int32)
    place = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=bits.device)
    return (b * place).sum(-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, width: int) -> torch.Tensor:
    """np.unpackbits along the last axis (MSB first), trimmed to `width`."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width]


def masked_paste(img: torch.Tensor, patch: torch.Tensor, box) -> torch.Tensor:
    """Write the valid (h, w) rectangle of `patch` into `img` at (y, x), in
    place; the padded remainder of the patch leaves `img` untouched.

    :param img:   (C, H, W)
    :param patch: (C, PH, PW), padded beyond (h, w)
    :param box:   (y, x, h, w) host integers, inside the frame
    """
    y, x, h, w = (int(v) for v in box)
    img[:, y:y + h, x:x + w] = patch[:, :h, :w].to(img.dtype)
    return img


def _filter_planes(planes: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Zero-border per-channel correlation of (C, H, W) float planes with a
    (k, k) kernel, the augmenter's own blur."""
    k = kernel.shape[-1]
    return F.conv2d(planes[:, None], kernel[None, None], padding=k // 2)[:, 0]


def compose_aug_batch(frame0: torch.Tensor, c: dict):
    """Rebuild one object's dense augment batch from its packed pieces.

    :param frame0: (3, H, W) uint8, the real frame (slot 0)
    :param c: a dict from pack_compact_batch
    :return: (images (K, 3, H, W) uint8, labels (K, 1, H, W) uint8)
    """
    _, H, W = frame0.shape
    K = len(c["bg_idx"]) + 1
    inpainted = masked_paste(frame0.clone(), c["inpaint_patch"], c["inpaint_box"])
    images = frame0.new_empty((K, 3, H, W))
    images[0] = frame0
    labels = frame0.new_zeros((K, 1, H, W))
    labels[0, 0] = unpack_bits(c["mask_packed"], W)
    lbl_patches = unpack_bits(c["lbl_patches"], c["lbl_patches"].shape[-1] * 8)
    for i, (idx, blurred, box) in enumerate(zip(c["bg_idx"], c["blurred"], c["boxes"])):
        base = c["warp_bases"][idx - 1] if idx else inpainted
        if blurred:
            # a warped base was truncated to uint8 (that truncation IS the
            # dense value of its unblurred slots); + 0.5 recentres the
            # quantization error before the blur averages it. The inpainted
            # base holds exact integers and gets no offset.
            bg = _filter_planes(base.float() + (0.5 if idx else 0.0), c["kernels"][i])
            images[i + 1] = bg.to(torch.uint8)
        else:
            images[i + 1] = base
        masked_paste(images[i + 1], c["patches"][i], box)
        masked_paste(labels[i + 1], lbl_patches[i][None], box)
    return images, labels


def pack_compact_batch(compact, n_bases=None, kernel_size=None, patch_bucket=None) -> dict:
    """Stack a CompactAugBatch's pieces into fixed-shape tensors on their
    device. The padding arguments give several objects a common signature;
    none of them changes what compose_aug_batch returns.

    :param n_bases:      pad warp_bases to this count (zero frames, never
                         selected)
    :param kernel_size:  embed the blur kernels centred in this odd size
                         (zero taps add nothing)
    :param patch_bucket: (ph, pw) to pad every paste rectangle to
    :return: dict for compose_aug_batch; `bg_idx`, `blurred`, `boxes` and
             `inpaint_box` stay host values
    """
    dev = compact.image.device
    K1 = len(compact.patches)
    ks = max([k.shape[0] for k in compact.kernels] + [1])
    if kernel_size is not None:
        if kernel_size < ks or kernel_size % 2 != 1:
            raise ValueError(f"kernel_size {kernel_size}: need an odd size >= {ks}")
        ks = kernel_size
    kerns = np.zeros((K1, ks, ks), np.float32)
    for i, k in enumerate(compact.kernels):
        o = (ks - k.shape[0]) // 2
        kerns[i, o:o + k.shape[0], o:o + k.shape[1]] = k

    ph = max([p.shape[1] for p in compact.patches] + [1])
    pw = max([p.shape[2] for p in compact.patches] + [1])
    if patch_bucket is not None:
        if patch_bucket[0] < ph or patch_bucket[1] < pw:
            raise ValueError(f"patch_bucket {patch_bucket}: need at least {(ph, pw)}")
        ph, pw = patch_bucket
    patches = torch.zeros((K1, 3, ph, pw), dtype=torch.uint8, device=dev)
    lbls = torch.zeros((K1, ph, pw), dtype=torch.uint8, device=dev)
    for i, (p, l) in enumerate(zip(compact.patches, compact.lbl_patches)):
        patches[i, :, :p.shape[1], :p.shape[2]] = p
        lbls[i, :l.shape[0], :l.shape[1]] = l

    _, H, W = compact.image.shape
    nb = len(compact.warp_bases)
    if n_bases is not None:
        if n_bases < nb:
            raise ValueError(f"n_bases {n_bases}: the batch has {nb} warped bases")
        nb = n_bases
    bases = torch.zeros((nb, 3, H, W), dtype=torch.uint8, device=dev)
    for i, b in enumerate(compact.warp_bases):
        bases[i] = b

    return {
        "mask_packed": pack_bits(compact.mask),
        "inpaint_patch": compact.inpaint_patch,
        "inpaint_box": tuple(compact.inpaint_box),
        "warp_bases": bases,
        "bg_idx": [int(i) for i in compact.bg_idx],
        "blurred": [k.shape != (1, 1) for k in compact.kernels],
        "kernels": torch.from_numpy(kerns).to(dev),
        "patches": patches,
        "boxes": [tuple(int(v) for v in b) for b in compact.boxes],
        "lbl_patches": pack_bits(lbls),
    }
