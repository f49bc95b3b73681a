"""The slice as a whole: frtm_tpu's host-loop Tracker and the port's Tracker
driven frame by frame on the same synthetic sequence, with the same backbone,
refiner and target-model starting weights (converted), and the JAX
augmenter's batches fed to both — so the comparison isolates the tracker.
train_skipping=2 puts two filter re-solves inside the six frames."""
from dataclasses import replace

import numpy as np
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.config import eval_config as jax_eval_config
from frtm_tpu.data.synthetic import make_moving_square_sequence
from frtm_tpu.models import init_resnet, init_seg_network, resnet_out_channels
from frtm_tpu.models.augmenter import ImageAugmenter as JaxAugmenter
from frtm_tpu.models.discriminator import init_disc_params
from frtm_tpu.runtime.tracker import Tracker as JaxTracker
from frtm_tpu_torch.config import eval_config
from frtm_tpu_torch.data.synthetic import make_moving_square_sequence as torch_sequence
from frtm_tpu_torch.models.resnet import ResNet
from frtm_tpu_torch.models.seg_network import SegNetwork
from frtm_tpu_torch.runtime.tracker import Tracker
from frtm_tpu_torch.utils.convert import (disc_params_from_jax, init_resnet as t_init_resnet,
                                          init_seg_network as t_init_seg_network,
                                          resnet_from_jax, seg_network_from_jax)

ARCH = "resnet18"
SMALL = dict(init_iters=(3, 5), update_iters=(3,), memory_size=8, c_channels=16,
             train_skipping=2)


def _small(cfg):
    return replace(cfg, disc=replace(cfg.disc, **SMALL))


class FreshBatches:
    """A JAX augmenter whose `augment_first_frame` always returns arrays the
    caller owns (copy=True), whatever the caller asks for.

    frtm_tpu's fused tracker asks for copy=False and gets the augmenter's
    reused buffers, trusting `jnp.asarray` to copy them to the device before
    the next object's augmentation overwrites them. On the CPU backend
    `jnp.asarray` aliases a numpy buffer that is 64-byte aligned instead of
    copying it, so with two objects, in the processes where `np.empty`
    happened to return an aligned buffer, object 1's init batch holds object
    2's augmentation (the soft volume then moves by 0.19). Every test of the
    port that runs frtm_tpu's fused tracker with more than one object gives
    it this augmenter (`tracker.augmenter = FreshBatches(tracker.augmenter)`);
    test_torch_sequence_tracker.py holds the protection with a test."""

    def __init__(self, augmenter):
        self.inner = augmenter

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def augment_first_frame(self, image, mask, rng, copy=True, compact=False):
        return self.inner.augment_first_frame(image, mask, rng, copy=True, compact=compact)


class JaxAugmenterShim:
    """The JAX augmenter's batches in the port's layout (N, C, H, W) tensors."""

    def __init__(self, aug_params):
        self.aug = JaxAugmenter(aug_params)

    def augment_first_frame(self, image, mask, rng):
        ims, lbs = self.aug.augment_first_frame(image, mask, rng)
        return (torch.from_numpy(np.ascontiguousarray(ims.transpose(0, 3, 1, 2))),
                torch.from_numpy(np.ascontiguousarray(lbs.transpose(0, 3, 1, 2))))


def test_tracker_matches_jax_frame_by_frame():
    seq = make_moving_square_sequence(n_frames=6, size=(96, 128), square=24, seed=2)
    jcfg = _small(jax_eval_config(ARCH, fast=True, num_aug=3))
    tcfg = _small(eval_config(ARCH, fast=True, num_aug=3))
    backbone = init_resnet(jax.random.PRNGKey(1), ARCH)
    ch = {L: c for L, c in resnet_out_channels(ARCH).items() if L in jcfg.refnet_layers}
    refiner = init_seg_network(jax.random.PRNGKey(2), ch)
    # a random refiner's logits are nearly flat and below 0 here (all
    # background), so no update would ever run; a shift to a threshold
    # inside them would leave pixels on the merge's tie. So shift the head
    # bias until frame 1's logits are all >= 1: every pixel is soft
    # foreground, memory inserts and both re-solves happen
    p0 = init_disc_params(jax.random.PRNGKey(0), jcfg.disc)
    probe = JaxTracker(jcfg, backbone, refiner)
    probe.initialize(*seq[0])
    feats = probe._extract(backbone, jnp.asarray(seq[1][0])[None])
    y = np.asarray(probe._classify_refine(probe.targets[1].params, refiner, feats,
                                          (96, 128))[0], np.float64)
    logits = np.log(y) - np.log1p(-y)
    conv2 = refiner["up"]["conv2"]
    shift = float(logits.min()) - 1.0
    refiner["up"]["conv2"] = dict(conv2, b=conv2["b"] - shift)
    jax_tracker = JaxTracker(jcfg, backbone, refiner)

    tb = ResNet(ARCH)
    tb.load_state_dict(resnet_from_jax(jax.tree.map(np.asarray, backbone)))
    tr = SegNetwork(ch)
    tr.load_state_dict(seg_network_from_jax(jax.tree.map(np.asarray, refiner)))
    port = Tracker(tcfg, tb, tr, device="cpu",
                   disc_params0=disc_params_from_jax(np.asarray(p0.project),
                                                     np.asarray(p0.filter)),
                   augmenter=JaxAugmenterShim(jcfg.aug_params))
    lut_j = jnp.asarray([0, 1], jnp.int32)
    lut_t = torch.tensor([0, 1], dtype=torch.int32)
    from frtm_tpu.runtime.tracker import masks_to_labels as jax_labels
    from frtm_tpu_torch.runtime.tracker import masks_to_labels

    for i in range(len(seq)):
        image, labels, new_objects = seq[i]
        tracked = bool(port.targets)
        for trk in (jax_tracker, port):
            if new_objects:
                trk.initialize(image, labels, new_objects)
        if tracked:
            jm = np.asarray(jax_tracker.track(image))
            tm = port.track(image)
            # soft masks (~0.91 here), not only labels; measured max abs
            # diff 2.4e-7
            np.testing.assert_allclose(tm.numpy(), jm, atol=1e-5)
            np.testing.assert_array_equal(masks_to_labels(tm, lut_t).numpy(),
                                          np.asarray(jax_labels(jnp.asarray(jm), lut_j)))
        for trk in (jax_tracker, port):
            trk.current_frame += 1
        jf = np.transpose(np.asarray(jax_tracker.targets[1].params.filter), (3, 2, 0, 1))
        tf = port.targets[1].params.filter[0].numpy()     # the one object's lane
        # CG filters: measured max diff 2.4e-3 of the peak. The phase-1 solve
        # is ill-conditioned at this size: frtm_tpu's own filter moves by
        # 2e-2 of its peak when its input features move by 1e-6 (relative),
        # so no tighter bound is meaningful; the masks above stay at 2.4e-7
        np.testing.assert_allclose(tf, jf, rtol=1e-2, atol=1e-2 * np.abs(jf).max())

    assert port.targets[1].state.n_resolves.tolist() == [2]
    assert int(jax_tracker.targets[1].state.frame_num) == port.targets[1].state.frame_num[0] == 5


def test_port_tracker_with_its_own_augmenter_is_deterministic():
    cfg = _small(eval_config(ARCH, fast=True, num_aug=3))
    seq = torch_sequence(n_frames=4, size=(96, 128), square=24, seed=2)
    ch = {L: c for L, c in resnet_out_channels(ARCH).items() if L in cfg.refnet_layers}
    runs = []
    for speedrun in (False, True):      # the warm-up pass leaves nothing behind
        tracker = Tracker(cfg, t_init_resnet(ARCH, torch.Generator().manual_seed(1), "cpu"),
                          t_init_seg_network(ch, torch.Generator().manual_seed(2),
                                             device="cpu"),
                          device="cpu")
        outputs, fps = tracker.run_sequence(seq, speedrun=speedrun)
        runs.append((outputs, tracker.current_masks.clone(),
                     tracker.targets[1].params.filter.clone()))
        assert fps > 0
    (o1, m1, f1), (o2, m2, f2) = runs
    assert len(o1) == 4 and all(o.shape == (96, 128) and o.dtype == np.uint8 for o in o1)
    assert torch.isfinite(m1).all() and torch.isfinite(f1).all()
    for a, b in zip(o1, o2):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(m1, m2) and torch.equal(f1, f2)
