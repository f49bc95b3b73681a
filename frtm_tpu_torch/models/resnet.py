"""Frozen ResNet-18/34/50/101 feature pyramid (frtm_tpu/models/resnet.py).

Raw 0..255 images go in; the ImageNet normalisation is folded into one
affine `x * norm_weight + norm_bias`. `extract_features` returns layer1..layer5
= stem+maxpool and the four residual stages (strides 4, 4, 8, 16, 32).
Parameter names follow torchvision (conv1, bn1, layer1.0.conv1, ...,
layerN.0.downsample.{0,1}), so a reference state dict loads with
`load_state_dict`. Batch norm is always the inference form.

The module computes in the type of its own parameters: for bfloat16, take
`compute_copy(net, torch.bfloat16)` (ops/conv.py) once and call that. Then,
as in the JAX package, the image is cast to bfloat16 before the
normalisation, whose two constants are the float32 ones rounded, and every
convolution and batch norm runs on bfloat16 weights and statistics.
"""
import numpy as np
import torch
import torch.nn as nn

from ..ops.conv import FrozenBatchNorm2d, conv2d, max_pool_3x3_s2, relu

RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resnet_out_channels(arch: str):
    """Deep-to-shallow {layer_name: channels} (the decoder's ordering)."""
    block, _ = RESNET_SPECS[arch]
    e = 4 if block == "bottleneck" else 1
    return {"layer5": 512 * e, "layer4": 256 * e, "layer3": 128 * e,
            "layer2": 64 * e, "layer1": 64}


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, w, stride):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, w, 3, stride)
        self.bn1 = FrozenBatchNorm2d(w)
        self.conv2 = _conv(w, w, 3)
        self.bn2 = FrozenBatchNorm2d(w)
        self.downsample = None
        if stride != 1 or cin != w:
            self.downsample = nn.Sequential(_conv(cin, w, 1, stride), FrozenBatchNorm2d(w))

    def forward(self, x):
        h = relu(self.bn1(conv2d(x, self.conv1.weight, stride=self.stride)))
        h = self.bn2(conv2d(h, self.conv2.weight))
        idn = x if self.downsample is None else self.downsample[1](
            conv2d(x, self.downsample[0].weight, stride=self.stride))
        return relu(h + idn)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, w, stride):
        super().__init__()
        cout = 4 * w
        self.stride = stride
        self.conv1 = _conv(cin, w, 1)
        self.bn1 = FrozenBatchNorm2d(w)
        self.conv2 = _conv(w, w, 3, stride)
        self.bn2 = FrozenBatchNorm2d(w)
        self.conv3 = _conv(w, cout, 1)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            FrozenBatchNorm2d(cout))

    def forward(self, x):
        h = relu(self.bn1(conv2d(x, self.conv1.weight)))
        h = relu(self.bn2(conv2d(h, self.conv2.weight, stride=self.stride)))
        h = self.bn3(conv2d(h, self.conv3.weight))
        idn = x if self.downsample is None else self.downsample[1](
            conv2d(x, self.downsample[0].weight, stride=self.stride))
        return relu(h + idn)


class ResNet(nn.Module):
    """The frozen backbone; `extract_features` is its only apply."""

    def __init__(self, arch: str):
        super().__init__()
        block, depths = RESNET_SPECS[arch]
        Block = BasicBlock if block == "basic" else Bottleneck
        self.arch = arch
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for si, (w, d) in enumerate(zip((64, 128, 256, 512), depths)):
            blocks = []
            for bi in range(d):
                blocks.append(Block(cin, w, 2 if (si > 0 and bi == 0) else 1))
                cin = w * Block.expansion
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
        self.register_buffer("norm_weight", torch.from_numpy(1.0 / 255.0 / _IMAGENET_STD),
                             persistent=False)
        self.register_buffer("norm_bias", torch.from_numpy(-_IMAGENET_MEAN / _IMAGENET_STD),
                             persistent=False)
        self.requires_grad_(False)

    @torch.no_grad()
    def extract_features(self, images, output_layers=None, out_dtype=torch.float32):
        """:param images: (N, 3, H, W) holding 0..255 values (any dtype)
        :param output_layers: optional iterable of layer names to keep
        :param out_dtype: type of the emitted maps (bfloat16 halves the
            pyramid for consumers that compute in it; the solver takes float32)
        :return: {layer1..layer5: (N, c, h, w) feature maps}"""
        want = None if output_layers is None else set(output_layers)
        deepest = "layer5" if want is None else max(want)
        dtype = self.conv1.weight.dtype
        x = images.to(dtype) * self.norm_weight[:, None, None] + self.norm_bias[:, None, None]
        out = {}

        def save(name, t):
            if want is None or name in want:
                out[name] = t.to(out_dtype)

        x = relu(self.bn1(conv2d(x, self.conv1.weight, stride=2)))
        x = max_pool_3x3_s2(x)
        save("layer1", x)
        if deepest == "layer1":
            return out
        for si in range(4):
            name = f"layer{si + 2}"
            x = getattr(self, f"layer{si + 1}")(x)
            save(name, x)
            if name == deepest:
                break
        return out

    forward = extract_features
