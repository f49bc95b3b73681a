"""Multilayer target models (frtm_tpu/models/multilayer.py): one target
model per backbone layer of `cfg.disc_layers`, initialised, applied and
updated in lock-step with the shared merged mask. Plain dicts keyed by layer
name over the single-layer functions of models/discriminator.py; layers go
in sorted name order, which is also the order of the score maps that the
decoder concatenates."""
from dataclasses import replace
from typing import Dict

import torch

from ..config import DiscConfig
from .discriminator import DiscParams, disc_apply, disc_init, disc_update, init_disc_params


def ml_init_params(cfgs: Dict[str, DiscConfig], generator: torch.Generator, device=None,
                   init=init_disc_params) -> Dict[str, DiscParams]:
    """Starting weights per layer, drawn by `init` from one generator in
    layer order."""
    return {L: init(cfg, generator, device) for L, cfg in sorted(cfgs.items())}


def ml_disc_init(params0: Dict[str, DiscParams], features, labels, cfgs: Dict[str, DiscConfig]):
    """One target model per layer and object on the layer's feature map:
    per layer one disc_init of all N objects.

    :param params0: {layer: DiscParams with the object axis}
    :param features: {layer: (N, K, C_L, h_L, w_L)} augmented first-frame features
    :param labels:   (N, K, 1, H, W) augmented masks, shared by the layers
    :return: ({layer: DiscParams}, {layer: DiscState}), each with the object axis
    """
    params, states = {}, {}
    for L in sorted(cfgs):
        params[L], states[L] = disc_init(params0[L], features[L], labels, cfgs[L])
    return params, states


def ml_disc_apply(params: Dict[str, DiscParams], features, cfgs: Dict[str, DiscConfig]):
    """Classify with every layer's model: ([scores per layer in sorted name
    order], {layer: compressed sample})."""
    scores, cfts = [], {}
    for L in sorted(params):
        s, cfts[L] = disc_apply(params[L], features[L], clamp_output=cfgs[L].clamp_output)
        scores.append(s)
    return scores, cfts


def ml_disc_update(params, states, cfts, train_y, cfgs: Dict[str, DiscConfig]):
    """The host loop's per-frame online update of every layer's model of
    one object with the shared merged mask train_y (1, 1, H, W)."""
    new_p, new_s = {}, {}
    for L in sorted(params):
        new_p[L], new_s[L] = disc_update(params[L], states[L], cfts[L], train_y, cfgs[L])
    return new_p, new_s


def layer_configs(cfg) -> Dict[str, DiscConfig]:
    """A tracker's target-model configurations by layer, in sorted name
    order: one per name in cfg.disc_layers, each with that layer's input
    width, or {cfg.disc.layer: cfg.disc} for the single-layer model."""
    if not cfg.disc_layers:
        return {cfg.disc.layer: cfg.disc}
    from .resnet import resnet_out_channels
    ch = resnet_out_channels(cfg.feature_extractor)
    return {L: replace(cfg.disc, in_channels=ch[L], layer=L) for L in sorted(cfg.disc_layers)}


def starting_params(cfg, cfgs: Dict[str, DiscConfig], disc_params0, device,
                    init=init_disc_params):
    """The target models' starting weights on `device`: `disc_params0` as
    given (DiscParams, or {layer: DiscParams} with cfg.disc_layers), or
    drawn by `init` (init_disc_params: the port's seeded init, generator
    seed 0; per layer in sorted order)."""
    if disc_params0 is None:
        gen = torch.Generator().manual_seed(0)
        disc_params0 = (ml_init_params(cfgs, gen, device, init) if cfg.disc_layers
                        else init(cfg.disc, gen, device))
    if isinstance(disc_params0, dict):
        return {L: DiscParams(*(t.to(device) for t in p)) for L, p in disc_params0.items()}
    return DiscParams(*(t.to(device) for t in disc_params0))
