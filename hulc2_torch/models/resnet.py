"""torchvision-layout ResNets with inference-only BatchNorm (``hulc2_tpu/models/resnet.py:22-131``).

NCHW in, ``[input, stem, layer1, layer2, layer3, layer4]`` out: the U-Net
encoder contract of the affordance stream, and the trunk of the pretrained
encoders (R3M, the tactile streams, ``vision_resnet``, ``vision_resnet_aff``).
``ResNet(arch)`` builds ``resnet18`` and ``resnet34`` from ``BasicBlock`` and
``resnet50`` from ``Bottleneck`` (a 1x1, 3x3 and 1x1 convolution, four times
as wide out as in); ``out_channels`` gives each level's width. The stem is a
7x7/2 convolution with padding 3, BN and ReLU, then a 3x3/2 max pool with
padding 1 (torch's max pool pads with -inf, as the JAX package does
explicitly). A block that changes width or stride has a 1x1 downsample.
Every BatchNorm is ``TorchBatchNorm``: it always normalizes with its stored
statistics, whatever the module's mode, so ``model.train()`` never turns a
trunk to batch statistics; ``conv_bn`` folds it into the convolution before
it, so a block's normalization costs no pass over its activations (under a
bf16 autocast a separate fp32 BatchNorm would widen them to fp32), and
without a graph on the card (a frozen trunk) runs the convolution, its bias,
the residual add and the ReLU as one cuDNN call (``PERF.md`` §6).
``frozen_stages`` runs the first N levels of [stem, layer1..layer4] without
a graph (the JAX module's stop-gradient on their outputs), so they take that
fused path while a later level trains.
Parameter names follow the JAX module names (``layer1_0.conv1``,
``ds_conv``, ``ds_bn``); ``utils/convert.convert_torchvision_resnet`` maps
torchvision's names onto them.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class TorchBatchNorm(nn.Module):
    """BatchNorm with stored statistics only, eps 1e-5: ``x * inv + (bias -
    mean * inv)`` with ``inv = weight / sqrt(var + eps)``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def conv_bn(conv: nn.Conv2d, bn: TorchBatchNorm, x: torch.Tensor, relu: bool = False,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bn(conv(x)) [+ residual]``, then the ReLU if ``relu``, with the
    BatchNorm's scale folded into the kernel and its shift into the bias
    (gradients reach the conv and the BatchNorm's parameters through the
    fold). On the card without a graph a ReLU'd one is cuDNN's fused
    convolution + bias [+ add] + ReLU, in the autocast's dtype."""
    inv = bn.weight * torch.rsqrt(bn.running_var + 1e-5)
    w, b = conv.weight * inv[:, None, None, None], bn.bias - bn.running_mean * inv
    if relu and x.is_cuda and not torch.is_grad_enabled():
        dt = torch.get_autocast_dtype("cuda") if torch.is_autocast_enabled("cuda") else x.dtype
        args = (conv.stride, conv.padding, conv.dilation, conv.groups)
        if residual is None:
            return torch.cudnn_convolution_relu(x.to(dt), w.to(dt), b.to(dt), *args)
        return torch.cudnn_convolution_add_relu(x.to(dt), w.to(dt), residual.to(dt), 1.0,
                                                b.to(dt), *args)
    y = F.conv2d(x, w, b, conv.stride, conv.padding)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at two deviations with
    variance 1/fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class NoBiasConv(nn.Conv2d):
    """nn.Conv2d without bias, padding ``kernel // 2`` unless given, with
    flax's lecun-normal init."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding=None):
        super().__init__(cin, cout, kernel, stride, kernel // 2 if padding is None else padding,
                         bias=False)

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, generator)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = NoBiasConv(cin, features, 3, stride)
        self.bn1 = TorchBatchNorm(features)
        self.conv2 = NoBiasConv(features, features, 3)
        self.bn2 = TorchBatchNorm(features)
        if downsample:
            self.ds_conv = NoBiasConv(cin, features, 1, stride, padding=0)
            self.ds_bn = TorchBatchNorm(features)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn(self.conv1, self.bn1, x, relu=True)
        identity = conv_bn(self.ds_conv, self.ds_bn, x) if self.downsample else x
        return conv_bn(self.conv2, self.bn2, y, relu=True, residual=identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 to ``4 * features`` (``resnet.py:58-75``)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = 4 * features
        self.conv1 = NoBiasConv(cin, features, 1, padding=0)
        self.bn1 = TorchBatchNorm(features)
        self.conv2 = NoBiasConv(features, features, 3, stride)
        self.bn2 = TorchBatchNorm(features)
        self.conv3 = NoBiasConv(features, out, 1, padding=0)
        self.bn3 = TorchBatchNorm(out)
        if downsample:
            self.ds_conv = NoBiasConv(cin, out, 1, stride, padding=0)
            self.ds_bn = TorchBatchNorm(out)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn(self.conv1, self.bn1, x, relu=True)
        y = conv_bn(self.conv2, self.bn2, y, relu=True)
        identity = conv_bn(self.ds_conv, self.ds_bn, x) if self.downsample else x
        return conv_bn(self.conv3, self.bn3, y, relu=True, residual=identity)


# arch -> (block, blocks per stage)
ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def resnet_out_channels(arch: str) -> tuple:
    exp = ARCHS[arch][0].expansion
    return (3, 64, 64 * exp, 128 * exp, 256 * exp, 512 * exp)


class ResNet(nn.Module):
    def __init__(self, arch: str = "resnet18", frozen_stages: int = 0):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"unknown ResNet arch {arch!r}; known: {sorted(ARCHS)}")
        block, layers = ARCHS[arch]
        self.arch, self.layers, self.frozen_stages = arch, layers, frozen_stages
        self.out_channels = resnet_out_channels(arch)
        self.conv1 = NoBiasConv(3, 64, 7, 2, padding=3)
        self.bn1 = TorchBatchNorm(64)
        cin = 64
        for stage, width in enumerate((64, 128, 256, 512)):
            for b in range(layers[stage]):
                stride = 2 if (b == 0 and stage > 0) else 1
                ds = b == 0 and (stride != 1 or cin != width * block.expansion)
                self.add_module(f"layer{stage + 1}_{b}", block(cin, width, stride, ds))
                cin = width * block.expansion

    def forward(self, x: torch.Tensor, depth: Optional[int] = None) -> List[torch.Tensor]:
        """The levels up to ``depth`` (all five by default): a depth-3 trunk
        stops after layer2, as smp's ``get_encoder(depth=3)`` does."""
        depth = 5 if depth is None else depth
        feats = [x]
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.frozen_stages < 1):
            y = conv_bn(self.conv1, self.bn1, x, relu=True)
        feats.append(y)  # stride 2
        y = F.max_pool2d(y, 3, 2, padding=1)
        for stage in range(1, depth):
            with torch.set_grad_enabled(torch.is_grad_enabled() and self.frozen_stages < stage + 1):
                for b in range(self.layers[stage - 1]):
                    y = getattr(self, f"layer{stage}_{b}")(y)
            feats.append(y)
        return feats


class ResNet18(ResNet):
    """The affordance encoder's trunk: ``ResNet("resnet18")``."""

    out_channels = resnet_out_channels("resnet18")

    def __init__(self):
        super().__init__("resnet18")
