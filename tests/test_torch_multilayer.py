"""Multilayer target models (one per backbone layer of cfg.disc_layers, their
score maps concatenated for the decoder) and the legacy bicubic upsampler in
the port against frtm_tpu: the ml_* functions, the decoder on a score list,
and both trackers with two layers on the same synthetic sequence, the same
converted weights and the JAX augmenter's batches.

Tolerances: scores and logits within 1e-3 of their peak (the init solve is
ill-conditioned at these sizes, ROADMAP.md section 4, F5; the decoder alone
within 1e-5); tracked labels on under 0.5 % of a frame's pixels, the bound
of the single-layer tracker tests. The weights are made as in
test_torch_sequence_tracker.py: the score channels of every TSE scaled by
SCORE_GAIN, the head scaled to a spread of HEAD_SPREAD on frame 1, so that
the masks follow the target models and hold both classes."""
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.config import eval_config as jax_eval_config
from frtm_tpu.data.synthetic import make_moving_square_sequence
from frtm_tpu.models import init_resnet, init_seg_network, resnet_out_channels
from frtm_tpu.models import multilayer as jml
from frtm_tpu.models.discriminator import DiscConfig as JaxDiscConfig
from frtm_tpu.models.seg_network import seg_network_apply as jax_seg_apply
from frtm_tpu.runtime.sequence_tracker import BatchedSequenceTracker as JaxFused
from frtm_tpu.runtime.tracker import Tracker as JaxTracker
from frtm_tpu_torch.config import DiscConfig, eval_config
from frtm_tpu_torch.models import multilayer as tml
from frtm_tpu_torch.models.resnet import ResNet
from frtm_tpu_torch.models.seg_network import SegNetwork, seg_network_apply
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from frtm_tpu_torch.runtime.tracker import Tracker
from frtm_tpu_torch.utils.convert import (disc_params_from_jax, resnet_from_jax,
                                          seg_network_from_jax)
from test_torch_tracker import SMALL, FreshBatches, JaxAugmenterShim

torch.set_num_threads(2)

ARCH = "resnet18"
LAYERS = ("layer4", "layer3")
SIZE, SQUARE = (48, 64), 14
SCORE_GAIN = 300.0
HEAD_SPREAD = 0.5


def t(a):
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def n(x):
    """NCHW tensor -> NHWC numpy."""
    return np.moveaxis(x.numpy(), 1, -1)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()))


def _convert_p0(p0):
    return {L: disc_params_from_jax(np.asarray(p.project), np.asarray(p.filter))
            for L, p in p0.items()}


def test_ml_functions_match_jax(rng):
    K, H, W = 3, 48, 64
    shapes = {"layer4": (6, 8, 16), "layer3": (12, 16, 8)}
    kw = dict(c_channels=8, init_iters=(2, 3), update_iters=(3,), memory_size=6,
              train_skipping=1)
    jcfgs = {L: JaxDiscConfig(in_channels=c, layer=L, **kw) for L, (_, _, c) in shapes.items()}
    tcfgs = {L: DiscConfig(in_channels=c, layer=L, **kw) for L, (_, _, c) in shapes.items()}
    feats = {L: rng.randn(K, h, w, c).astype(np.float32) * 0.3 for L, (h, w, c) in shapes.items()}
    masks = np.zeros((K, H, W, 1), np.float32)
    masks[:, 10:34, 14:44] = 1
    p0 = jml.ml_init_params(jax.random.PRNGKey(0), jcfgs)
    jp, js = jml.ml_disc_init(p0, {L: jnp.asarray(f) for L, f in feats.items()},
                              jnp.asarray(masks), jcfgs)
    tp, ts = tml.ml_disc_init(_convert_p0(p0), {L: t(f) for L, f in feats.items()}, t(masks),
                              tcfgs)
    assert list(tp) == list(ts) == ["layer3", "layer4"]
    jscores, jcfts = jml.ml_disc_apply(jp, {L: jnp.asarray(f) for L, f in feats.items()}, jcfgs)
    tscores, tcfts = tml.ml_disc_apply(tp, {L: t(f) for L, f in feats.items()}, tcfgs)
    assert len(tscores) == 2
    for a, b in zip(tscores, jscores):
        _close(n(a), b, 1e-3)
    # the lock-step update, with a re-solve of every layer (train_skipping 1)
    y = masks[0] * 0.9
    jp, js = jml.ml_disc_update(jp, js, {L: c[0] for L, c in jcfts.items()}, jnp.asarray(y),
                                jcfgs)
    tp, ts = tml.ml_disc_update(tp, ts, {L: c[0] for L, c in tcfts.items()}, t(y[None])[0],
                                tcfgs)
    for L in shapes:
        assert ts[L].frame_num == int(js[L].frame_num) == 1
        assert int(ts[L].memory.current_size) == int(js[L].memory.current_size) == K + 1
        assert ts[L].n_resolves == 1
    jscores, _ = jml.ml_disc_apply(jp, {L: jnp.asarray(f) for L, f in feats.items()}, jcfgs)
    tscores, _ = tml.ml_disc_apply(tp, {L: t(f) for L, f in feats.items()}, tcfgs)
    for a, b in zip(tscores, jscores):
        _close(n(a), b, 1e-3)


@pytest.mark.parametrize("upsampler", ["pyrup", "bicubic"])
@pytest.mark.parametrize("n_scores", [1, 2])
def test_decoder_matches_jax(rng, upsampler, n_scores):
    """The decoder on one score map or a list of two (TSE in_channels = 2),
    with the default pyrup head or the legacy bicubic one; the two heads
    differ."""
    dec_ft = {"layer5": (3, 4, 32), "layer4": (6, 8, 16), "layer3": (12, 16, 8),
              "layer2": (24, 32, 8)}
    dec = init_seg_network(jax.random.PRNGKey(1), {L: c for L, (_, _, c) in dec_ft.items()},
                           in_channels=n_scores)
    port = SegNetwork({L: c for L, (_, _, c) in dec_ft.items()}, in_channels=n_scores)
    port.load_state_dict(seg_network_from_jax(jax.tree.map(np.asarray, dec)))
    feats = {L: rng.randn(2, h, w, c).astype(np.float32) for L, (h, w, c) in dec_ft.items()}
    scores = [rng.randn(2, h, w, 1).astype(np.float32) for h, w in ((6, 8), (12, 16))][:n_scores]
    jscores = [jnp.asarray(s) for s in scores] if n_scores > 1 else jnp.asarray(scores[0])
    tscores = [t(s) for s in scores] if n_scores > 1 else t(scores[0])
    want = jax_seg_apply(dec, jscores, {L: jnp.asarray(f) for L, f in feats.items()}, (48, 64),
                         upsampler=upsampler)
    got = seg_network_apply(port, tscores, {L: t(f) for L, f in feats.items()}, (48, 64),
                            upsampler=upsampler)
    assert got.shape == (2, 1, 48, 64)
    _close(n(got), want, 1e-5)
    other = seg_network_apply(port, tscores, {L: t(f) for L, f in feats.items()}, (48, 64),
                              upsampler="bicubic" if upsampler == "pyrup" else "pyrup")
    assert not torch.allclose(got, other)
    with pytest.raises(ValueError):
        seg_network_apply(port, tscores, {L: t(f) for L, f in feats.items()}, (48, 64),
                          upsampler="nearest")


def _sequence(n_frames, n_objects, starts=None, seed=2):
    seq = make_moving_square_sequence(n_frames=n_frames, size=SIZE, square=SQUARE,
                                      n_objects=n_objects, seed=seed)
    if starts:
        seq.start_frames = starts
    return seq


class World:
    """Two-layer weights and trackers shared by this module's tracker tests."""

    def __init__(self):
        small = lambda c: replace(c, disc=replace(c.disc, **SMALL), disc_layers=LAYERS)
        self.jcfg = small(jax_eval_config(ARCH, fast=True, num_aug=3))
        self.tcfg = small(eval_config(ARCH, fast=True, num_aug=3))
        self.backbone = init_resnet(jax.random.PRNGKey(1), ARCH)
        self.ch = {L: c for L, c in resnet_out_channels(ARCH).items()
                   if L in self.jcfg.refnet_layers}
        refiner = init_seg_network(jax.random.PRNGKey(2), self.ch, in_channels=len(LAYERS))
        for p in refiner["tse"].values():
            w = np.array(p["transform1"]["w"])
            w[:, :, -len(LAYERS):, :] *= SCORE_GAIN     # HWIO: the scores are the last inputs
            p["transform1"] = dict(p["transform1"], w=jnp.asarray(w))
        self.refiner = refiner
        self.p0 = _convert_p0(JaxTracker(self.jcfg, self.backbone, refiner)._disc_params0)
        # scale the head from the port's own frame-1 logits (two objects)
        vol, _ = self.fused("deferred").run_sequence(_sequence(2, 2), soft=True)
        y = np.clip(vol[1].astype(np.float64), 1e-12, 1 - 1e-12)
        logits = np.log(y) - np.log1p(-y)
        scale = HEAD_SPREAD / float(logits.std())
        conv2 = refiner["up"]["conv2"]
        refiner["up"]["conv2"] = dict(conv2, w=conv2["w"] * scale,
                                      b=(conv2["b"] - float(np.median(logits))) * scale)
        # frtm_tpu's trackers, made once: they compile per shape
        self.jax_host = JaxTracker(self.jcfg, self.backbone, refiner)
        self.jax_fused = JaxFused(self.jcfg, self.backbone, refiner, extract_chunk=4,
                                  scan_bucket=8)
        self.jax_fused.augmenter = FreshBatches(self.jax_fused.augmenter)

    def models(self):
        tb = ResNet(ARCH)
        tb.load_state_dict(resnet_from_jax(jax.tree.map(np.asarray, self.backbone)))
        tr = SegNetwork(self.ch, in_channels=len(LAYERS))
        tr.load_state_dict(seg_network_from_jax(jax.tree.map(np.asarray, self.refiner)))
        return tb, tr

    def fused(self, merge_mode="online", **kw):
        return BatchedSequenceTracker(self.tcfg, *self.models(), extract_chunk=4,
                                      merge_mode=merge_mode, device="cpu", disc_params0=self.p0,
                                      augmenter=JaxAugmenterShim(self.jcfg.aug_params), **kw)

    def host(self):
        return Tracker(self.tcfg, *self.models(), device="cpu", disc_params0=self.p0,
                       augmenter=JaxAugmenterShim(self.jcfg.aug_params))


@pytest.fixture(scope="module")
def world():
    return World()


def _labels_close(got, want, n_objects, bound=0.005, all_from=1):
    """Labels within `bound`; every object and the background hold pixels
    in the tracked frames from `all_from` on (the comparison is not of
    constant masks)."""
    assert len(got) == len(want)
    worst = max(float(np.mean(a != b)) for a, b in zip(got, want))
    assert worst < bound, [float(np.mean(a != b)) for a, b in zip(got, want)]
    for lb in want[all_from:]:
        counts = [int((lb == i).sum()) for i in range(n_objects + 1)]
        assert min(counts) >= 10, counts


@pytest.mark.parametrize("n_objects", [1, 2])
def test_host_loop_two_layers_matches_jax(world, n_objects):
    seq = _sequence(6, n_objects)
    want, _ = world.jax_host.run_sequence(seq)
    port = world.host()
    got, _ = port.run_sequence(seq)
    _labels_close(got, want, n_objects)
    target = port.targets[1]
    assert set(target.params) == set(target.state) == set(LAYERS)
    assert [target.state[L].n_resolves for L in sorted(LAYERS)] == [2, 2]
    assert not torch.allclose(target.params["layer3"].filter, target.params["layer4"].filter)


@pytest.mark.parametrize("n_objects,starts", [(1, None), (2, None), (2, {"00000": [1], "00003": [2]})],
                         ids=["one", "two", "two_entry_at_3"])
def test_fused_two_layers_matches_jax(world, n_objects, starts):
    """The windowed loop (all objects from frame 0) and the per-frame loop
    (object 2 enters at frame 3) against frtm_tpu's fused tracker; both
    layers re-solve together, and the port's fused tracker equals its host
    loop where objects start at frame 0.

    With two objects frtm_tpu's own two engines disagree: its fused tracker
    solves the objects' init problems as one vmapped batch, and at this size
    the solve is ill-conditioned (F5), so its labels differ from its host
    loop's on up to 0.91 % of a frame (measured; with one object they are
    equal). The port's fused tracker follows the port's host loop exactly,
    which is within 0.23 % of frtm_tpu's host loop. So against the JAX fused
    tracker the bound is 0.5 % beyond the JAX engines' own gap, measured in
    the same test."""
    seq = _sequence(6, n_objects, starts)
    want, _ = world.jax_fused.run_sequence(seq)
    port = world.fused()
    got, _ = port.run_sequence(seq)
    resolves = [[int(s[L].n_resolves) for L in sorted(LAYERS)] for _, s in port.last_models]
    assert resolves == [[2, 2]] * n_objects if starts is None else [[2, 2], [1, 1]]
    jax_host, _ = world.jax_host.run_sequence(seq)
    jax_gap = max(float(np.mean(a != b)) for a, b in zip(want, jax_host))
    if n_objects == 1:
        assert jax_gap == 0.0
    _labels_close(got, want, n_objects, bound=0.005 + jax_gap, all_from=3 if starts else 1)
    if starts is None:
        for a, b in zip(world.host().run_sequence(seq)[0], got):
            np.testing.assert_array_equal(a, b)


def test_fused_two_layers_decode_chunk_changes_nothing(world):
    """Score lists split into decode sub-batches: the labels are equal."""
    seq = _sequence(5, 2)
    plain, _ = world.fused().run_sequence(seq)
    chunked, _ = world.fused(decode_chunk=2).run_sequence(seq)
    for a, b in zip(chunked, plain):
        np.testing.assert_array_equal(a, b)
