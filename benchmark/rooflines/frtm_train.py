"""Model FLOPs of one refiner train step with every target model cached
(the window of a training cell), built on frtm_model.py's counts: the
multiply-adds of the convolutions that the algorithm needs, counted twice,
nothing for element-wise work. All of it is float32 (the training recipe).

Per trained frame (frames 1..T-1 of each of the batch's samples):
* the frozen backbone's forward up to the deepest layer used;
* the sample's target model, forward: its 1x1 projection and 3x3 filter at
  its layer;
* the refiner's forward F (frtm_model.decoder: the TSE reductions and the
  rest of the decoder for one object), and its backward, 2 F: a weight and
  an input gradient of each convolution, less the input gradient of each
  TSE reduction's first convolution, whose input (the backbone's features)
  needs none.
"""
from .frtm_model import LEVEL_OF, backbone, channels, conv, decoder, level_sizes


def frame_flops(cfg: dict, H, W) -> float:
    """FLOPs of one trained frame of one sample."""
    arch, layers, oc = cfg["arch"], cfg["refnet_layers"], cfg["refnet_channels"]
    deepest = max(list(layers) + [cfg["layer"]], key=LEVEL_OF.get)
    sizes, ch = level_sizes(H, W), channels(arch)
    h, w = sizes[cfg["layer"]]
    c = cfg["c_channels"]
    target = conv(ch[cfg["layer"]], c, 1, h, w) + conv(c, 1, 3, h, w)
    per_frame, per_lane = decoder(arch, H, W, layers, oc)
    forward = per_frame + per_lane
    no_input_grad = sum(conv(ch[L], oc, 1, *sizes[L]) for L in layers)
    return backbone(arch, H, W, deepest) + target + 3 * forward - no_input_grad


def step_flops(cfg: dict, H, W, batch: int, frames: int) -> float:
    """FLOPs of one step of `batch` samples of `frames` frames each."""
    return batch * (frames - 1) * frame_flops(cfg, H, W)
