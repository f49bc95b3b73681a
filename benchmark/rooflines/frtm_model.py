"""Model FLOPs of the tracker's work, from the configuration's sizes alone:
multiply-adds of the convolutions and products that the algorithm needs,
counted twice (a multiply and an add), nothing for element-wise work. They
feed `mfu.track`: each part's FLOPs over the peak of the type it computes
in (backbone and decoder in the configuration's compute type, the target
model and its solver in float32), summed as time at peak.

* backbone: every convolution of the ResNet up to the deepest layer used, at
  the frame's size (k // 2 padding, so a stride-2 layer halves rounding up);
* decoder: per frame the object-independent TSE reductions, per object and
  frame the rest of the refiner (TSE transform, two RRBs, the upsampler's two
  3x3 convolutions);
* target model: per object and frame the 1x1 projection and the 3x3
  classification; per re-solve the GN-CG passes (a forward and a backward of
  the filter over the memory's samples for each CG step, plus one of each for
  the gradient of each GN step); per object the init: the augmented frames'
  backbone pass to the target layer, the joint solve over {projection,
  filter} on them and the filter-only solve.
"""
from math import ceil

SPECS = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet34": ("basic", (3, 4, 6, 3)),
         "resnet50": ("bottleneck", (3, 4, 6, 3)), "resnet101": ("bottleneck", (3, 4, 23, 3))}
LEVEL_OF = {"layer1": 1, "layer2": 2, "layer3": 3, "layer4": 4, "layer5": 5}


def conv(cin, cout, k, h, w) -> float:
    return 2.0 * cin * cout * k * k * h * w


def level_sizes(H, W) -> dict:
    """{layer: (h, w)}: the stem and pool quarter the frame, layer2 keeps
    it, each later stage halves it (rounding up)."""
    h, w = ceil(ceil(H / 2) / 2), ceil(ceil(W / 2) / 2)
    out = {"layer1": (h, w), "layer2": (h, w)}
    for L in ("layer3", "layer4", "layer5"):
        h, w = ceil(h / 2), ceil(w / 2)
        out[L] = (h, w)
    return out


def channels(arch) -> dict:
    e = 4 if SPECS[arch][0] == "bottleneck" else 1
    return {"layer5": 512 * e, "layer4": 256 * e, "layer3": 128 * e, "layer2": 64 * e,
            "layer1": 64}


def backbone(arch, H, W, deepest="layer5") -> float:
    block, depths = SPECS[arch]
    f = conv(3, 64, 7, ceil(H / 2), ceil(W / 2))
    sizes = level_sizes(H, W)
    cin = 64
    for si, (width, d) in enumerate(zip((64, 128, 256, 512), depths)):
        name = f"layer{si + 2}"
        if LEVEL_OF[name] > LEVEL_OF[deepest]:
            break
        h, w = sizes[name]
        hi, wi = sizes[f"layer{si + 1}"]
        for bi in range(d):
            c_in_block = cin if bi == 0 else (width * (4 if block == "bottleneck" else 1))
            hin, win = (hi, wi) if bi == 0 else (h, w)
            if block == "bottleneck":
                cout = 4 * width
                f += conv(c_in_block, width, 1, hin, win)
                f += conv(width, width, 3, h, w)
                f += conv(width, cout, 1, h, w)
            else:
                cout = width
                f += conv(c_in_block, width, 3, h, w)
                f += conv(width, width, 3, h, w)
            if bi == 0 and (si > 0 or c_in_block != cout):
                f += conv(c_in_block, cout, 1, h, w)
        cin = width * (4 if block == "bottleneck" else 1)
    return f


def decoder(arch, H, W, layers, oc) -> tuple:
    """(FLOPs per frame, FLOPs per object and frame)."""
    sizes, ch = level_sizes(H, W), channels(arch)
    per_frame = sum(conv(ch[L], oc, 1, *sizes[L]) + conv(oc, oc, 1, *sizes[L]) for L in layers)
    per_lane = 0.0
    for L in layers:
        h, w = sizes[L]
        nc = oc + 1
        per_lane += conv(nc, nc, 3, h, w) * 2 + conv(nc, oc, 3, h, w)
        per_lane += 2 * (conv(oc, oc, 1, h, w) + 2 * conv(oc, oc, 3, h, w))
    h, w = sizes[layers[-1]]
    per_lane += conv(oc, oc // 2, 3, 2 * h, 2 * w) + conv(oc // 2, 1, 3, H, W)
    return per_frame, per_lane


def target_model(arch, H, W, layer, c, memory, update_cg, init_cg, num_aug) -> dict:
    """{"frame": per object and frame, "resolve": per re-solve and object,
    "init": per object (its target-model part), "init_extract": the
    backbone FLOPs of one object's augmented frames}."""
    h, w = level_sizes(H, W)[layer]
    cin = channels(arch)[layer]
    filt = conv(c, 1, 3, h, w)
    proj = conv(cin, c, 1, h, w)
    n_gn_u, n_cg_u = len(update_cg), sum(update_cg)
    resolve = memory * filt * 2 * (n_cg_u + n_gn_u)
    joint = num_aug * (proj + filt) * 2 * (sum(init_cg) + len(init_cg))
    init = joint + num_aug * proj + num_aug * filt * 2 * (n_cg_u + n_gn_u)
    return {"frame": proj + filt, "resolve": resolve, "init": init,
            "init_extract": num_aug * backbone(arch, H, W, layer)}


def sequence_flops(cfg: dict, H, W, frames, objects) -> dict:
    """{"compute": FLOPs in the compute type, "float32": FLOPs in float32}
    of one tracked sequence of `frames` frames and `objects` objects, all
    starting in frame 0 (frames 1.. are tracked)."""
    arch, layers = cfg["arch"], cfg["refnet_layers"]
    tracked = frames - 1
    deepest = max(list(layers) + [cfg["layer"]], key=LEVEL_OF.get)
    per_frame, per_lane = decoder(arch, H, W, layers, cfg["refnet_channels"])
    tm = target_model(arch, H, W, cfg["layer"], cfg["c_channels"], cfg["memory_size"],
                      cfg["update_iters"], cfg["init_iters"], cfg["num_aug"])
    resolves = tracked // cfg["train_skipping"]
    compute = (tracked * (backbone(arch, H, W, deepest) + per_frame)
               + tracked * objects * per_lane + objects * tm["init_extract"])
    f32 = objects * (tracked * tm["frame"] + resolves * tm["resolve"] + tm["init"])
    return {"compute": compute, "float32": f32}
