"""One step of the refiner's training in plain float32 torch: the port's
runtime/trainer.py::TrainerModel.train_step written from its description
(frtm-vos train.py and the JAX package's trainer), with no kernel of the
port. TF32 is off for matmuls and cuDNN while it runs.

Per train frame t = 1 .. T-1 of a batch (images (T, B, H, W, 3) 0..255,
labels (T, B, H, W, 1) in {0, 1}, mask (B,) sample validity):

* the frozen backbone (reference/resnet.py) under no_grad, in blocks of
  `block` frames;
* each sample's scores under its own target model (`classify_per_sample`:
  its 1x1 projection, then its 3x3 filter, one sample at a time);
* the refiner in train mode (`decode`): the inference decoder of
  reference/seg_network.py with every RRB BatchNorm normalising by the
  batch's statistics over (N, H, W) (biased variance), its running
  statistics taking momentum 0.1 of the batch mean and of the unbiased
  batch variance, chained from frame to frame; kernels 1 and 2 in their
  plain versions (reference/kernels_plain.py), the resizes as
  reference/resize.py's matrices;
* the clamped-sigmoid BCE: p = clamp(sigmoid(logits), 1e-7, 1 - 1e-7), the
  pixel mean per sample, the masked sum over the batch over the valid
  count (at least 1), summed over the frames; the step's loss is that sum
  over T - 1;
* the gradients by autograd;
* one AMSGrad step in optax's order (`amsgrad_step`).

Departures from train.py, all of them the port's as well: the target models
are given (the trainer solves or reads them), the backbone is frozen, and
the BatchNorm statistics are one process's batch's. Frames are
differentiated one at a time: the loss is a sum over frames and no frame's
graph reaches another's (the running statistics carry no gradient), so only
one frame's graph is held.

`control=True` is the nearest precision below float32, TF32: allowed in
cuDNN and matmuls on the card, and emulated on any device by rounding the
operands of every convolution of the scores and of the refiner to TF32's
10-bit mantissa (`tf32_round`), so that it shows on the CPU too.
"""
import contextlib

import torch
import torch.nn.functional as F

from . import kernels_plain
from .resize import resize

BN_MOMENTUM = 0.1
BN_EPS = 1e-5
# the clamp of the sigmoid before the BCE's logarithms
P_CLAMP = 1e-7


@contextlib.contextmanager
def numerics(tf32: bool):
    """TF32 allowed (the control) or off (the reference) for the block."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits (to nearest, ties
    away from zero), kept in float32."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    # the straight-through form keeps autograd's gradient of the identity
    return x + (rounded - x).detach()


def _identity(x):
    return x


def classify_per_sample(project, filt, ft, q=_identity):
    """Sample b's scores under its own target model: project (B, c, Cin, 1,
    1), filt (B, 1, c, 3, 3), ft (B, Cin, h, w) -> (B, 1, h, w)."""
    out = []
    for b in range(ft.shape[0]):
        h = F.conv2d(q(ft[b:b + 1]), q(project[b]))
        out.append(F.conv2d(q(h), q(filt[b]), padding=1))
    return torch.cat(out)


def batch_norm_train(x, weight, bias, running_mean, running_var):
    """(normalised x with the batch's statistics, (new running mean, new
    running variance))."""
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
    y = ((x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS)
         * weight[:, None, None] + bias[:, None, None])
    n = x.shape[0] * x.shape[2] * x.shape[3]
    with torch.no_grad():
        new_mean = (1 - BN_MOMENTUM) * running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * running_var + BN_MOMENTUM * var * (n / max(n - 1, 1))
    return y, (new_mean, new_var)


def decode(p, stats, scores, features, image_size, layers, q=_identity):
    """The refiner in train mode. p: {state-dict key: parameter}; stats:
    {BatchNorm key prefix: (running mean, running var)}, replaced by the
    new statistics as the BatchNorms run. -> (N, 1, H, W) logits."""
    def conv(x, key, bias=True):
        w = p[f"{key}.weight"]
        return F.conv2d(q(x), q(w), p[f"{key}.bias"] if bias else None,
                        padding=w.shape[-1] // 2)

    def rrb(x, key):
        h = conv(x, f"{key}.conv1x1")
        bn = f"{key}.bblock.1"
        b, stats[bn] = batch_norm_train(conv(h, f"{key}.bblock.0"), p[f"{bn}.weight"],
                                        p[f"{bn}.bias"], *stats[bn])
        return F.relu(h + conv(F.relu(b), f"{key}.bblock.3", bias=False))

    x = None
    for L in layers:
        h0 = conv(F.relu(conv(features[L], f"TSE.{L}.reduce.0")), f"TSE.{L}.reduce.2")
        hpool = h0.mean(dim=(-2, -1), keepdim=True)
        s = resize(scores, h0.shape[-2:], "bilinear")
        h = torch.cat([h0, s], dim=1)
        for k in (0, 2, 4):
            h = F.relu(conv(h, f"TSE.{L}.transform.{k}"))
        h = rrb(h, f"RRB1.{L}")
        deeper = hpool if x is None else x
        deeper_pool = hpool if x is None else deeper.mean(dim=(-2, -1), keepdim=True)
        g = torch.cat([h.mean(dim=(-2, -1), keepdim=True), deeper_pool], dim=1)
        g = conv(F.relu(conv(g, f"CAB.{L}.convreluconv.0")), f"CAB.{L}.convreluconv.2")
        h = h * torch.sigmoid(g) + resize(deeper, h.shape[-2:], "bilinear")
        x = rrb(h, f"RRB2.{L}")
    x = kernels_plain.pyr_up_bicubic(x)
    x = F.relu(conv(x, "project.conv1"))
    x = kernels_plain.pyr_up_bicubic(x)
    x = resize(x, image_size, "bilinear")
    return kernels_plain.conv3x3_cout1(q(x), q(p["project.conv2.weight"]),
                                       p["project.conv2.bias"])


def bce(logits, y, mask, n_valid):
    """The masked mean over the batch of each sample's pixel-mean BCE."""
    pr = torch.clamp(torch.sigmoid(logits), P_CLAMP, 1 - P_CLAMP)
    per_sample = -(y * torch.log(pr) + (1 - y) * torch.log(1 - pr)).mean(dim=(1, 2, 3))
    return (per_sample * mask).sum() / n_valid


def amsgrad_step(params, grads, state, lr, weight_decay, b1=0.9, b2=0.999, eps=1e-8):
    """One step of the JAX package's optimizer chain in optax's order:
    g = grad + weight_decay * p; mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2
    + b2 nu; nu_max = max(nu_max, nu / (1 - b2^t)); p - lr (mu / (1 - b1^t))
    / (sqrt(nu_max) + eps). params, grads: {name: tensor}; state: {"count",
    "mu", "nu", "nu_max"} (dicts by name). Returns (new params, new state);
    the bias corrections are float32, as optax's."""
    t = int(state["count"]) + 1
    f32 = dict(dtype=torch.float32, device=next(iter(params.values())).device)
    bc1 = 1 - torch.tensor(b1, **f32) ** t
    bc2 = 1 - torch.tensor(b2, **f32) ** t
    new_p, mu, nu, nu_max = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k] + weight_decay * p
        mu[k] = (1 - b1) * g + b1 * state["mu"][k]
        nu[k] = (1 - b2) * g * g + b2 * state["nu"][k]
        nu_max[k] = torch.maximum(state["nu_max"][k], nu[k] / bc2)
        new_p[k] = p - lr * (mu[k] / bc1) / (torch.sqrt(nu_max[k]) + eps)
    return new_p, {"count": t, "mu": mu, "nu": nu, "nu_max": nu_max}


def train_step(backbone, refiner_state, project, filt, images, labels, mask, opt_state, lr,
               weight_decay, layers, disc_layer, device, control=False, block=8):
    """The step from the state before it. refiner_state: the refiner's
    state dict (parameters and BatchNorm buffers) before the step;
    project, filt: the batch's target models; opt_state: as amsgrad_step
    takes it. Returns {"loss", "grads", "params", "running", "opt_state"}
    (the new parameters and running statistics by state-dict key, the
    optimizer's state after the step)."""
    q = tf32_round if control else _identity
    p = {k: v.detach().to(device).float().clone().requires_grad_(True)
         for k, v in refiner_state.items() if k in opt_state["mu"]}
    stats = {k[:-len(".running_mean")]: (refiner_state[k].to(device).float(),
                                         refiner_state[k[:-4] + "var"].to(device).float())
             for k in refiner_state if k.endswith(".running_mean")}
    images = torch.as_tensor(images).to(device).permute(0, 1, 4, 2, 3)
    labels = torch.as_tensor(labels).to(device).permute(0, 1, 4, 2, 3).float()
    mask = torch.as_tensor(mask, dtype=torch.float32).to(device)
    n_valid = torch.clamp_min(mask.sum(), 1.0)
    want = set(layers) | {disc_layer}
    project, filt = project.to(device).float(), filt.to(device).float()
    T = images.shape[0]
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total = 0.0
    with numerics(control):
        for t in range(1, T):
            with torch.no_grad():
                feats = {}
                for s in range(0, images.shape[1], block):
                    got = backbone.extract_features(images[t, s:s + block], output_layers=want)
                    for L, v in got.items():
                        feats.setdefault(L, []).append(v)
                feats = {L: torch.cat(v) for L, v in feats.items()}
                scores = classify_per_sample(project, filt, feats[disc_layer], q)
            logits = decode(p, stats, scores, {L: feats[L] for L in layers},
                            tuple(images.shape[-2:]), layers, q)
            loss = bce(logits, labels[t], mask, n_valid)
            for k, g in zip(p, torch.autograd.grad(loss, list(p.values()))):
                grads[k] += g
            total = total + float(loss.detach())
            del feats, logits, loss
        new_p, new_state = amsgrad_step({k: v.detach() for k, v in p.items()}, grads,
                                        opt_state, lr, weight_decay)
    running = {}
    for prefix, (m, v) in stats.items():
        running[f"{prefix}.running_mean"] = m
        running[f"{prefix}.running_var"] = v
    return {"loss": total / (T - 1), "grads": grads, "params": new_p, "running": running,
            "opt_state": new_state}
