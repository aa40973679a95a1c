"""ResNet18 feature pyramid with inference-only BatchNorm (``hulc2_tpu/models/resnet.py:22-125``).

NCHW in, ``[input, stem, layer1, layer2, layer3, layer4]`` out: the U-Net
encoder contract of the affordance stream. The stem is a 7x7/2 convolution
with padding 3, BN and ReLU, then a 3x3/2 max pool with padding 1 (torch's
max pool pads with -inf, as the JAX package does explicitly). Each stage is
two ``BasicBlock``s; a block that changes width or stride has a 1x1
downsample. Every BatchNorm is ``TorchBatchNorm``: it always normalizes with
its stored statistics, whatever the module's mode, so ``model.train()`` on a
detector never turns the encoder to batch statistics. Parameter names follow
the JAX module names (``layer1_0.conv1``, ``ds_conv``, ``ds_bn``).
"""
from __future__ import annotations

import math
from typing import List

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
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(y + identity)


class ResNet18(nn.Module):
    out_channels = (3, 64, 64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        self.conv1 = NoBiasConv(3, 64, 7, 2, padding=3)
        self.bn1 = TorchBatchNorm(64)
        cin = 64
        for stage, width in enumerate((64, 128, 256, 512)):
            for b in range(2):
                stride = 2 if (b == 0 and stage > 0) else 1
                block = BasicBlock(cin, width, stride, b == 0 and (stride != 1 or cin != width))
                self.add_module(f"layer{stage + 1}_{b}", block)
                cin = width

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [x]
        y = F.relu(self.bn1(self.conv1(x)))
        feats.append(y)  # stride 2
        y = F.max_pool2d(y, 3, 2, padding=1)
        for stage in range(1, 5):
            y = getattr(self, f"layer{stage}_1")(getattr(self, f"layer{stage}_0")(y))
            feats.append(y)
        return feats
