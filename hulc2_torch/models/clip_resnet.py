"""CLIP's ModifiedResNet image tower (``hulc2_tpu/models/clip_resnet.py:31-108``).

OpenAI CLIP "RN50" and its kin: a three-conv stem with BN and a 2x2 average
pool, four stages of anti-aliased ``ClipBottleneck``s (a stride is a 2x2
average pool before the last 1x1 convolution, and before the downsample's),
and ``AttentionPool2d``: the mean token and the h*w tokens with a learned
positional table, one query (the mean token) over all of them, and a
projection to the joint embedding. NCHW in; tokens are taken in row-major
(h, w) order, as the NHWC JAX module takes them.

flax sizes the positional table (h*w + 1 rows) from the input at init; the
port sizes it from the input size the tower is built for
(``input_hw``, the camera's post-transform size; ``attnpool_grid``).
Parameter names are the JAX module's (``layer1_0.conv1``, ``ds_conv``,
``attnpool.q_proj``); ``utils/convert.convert_clip_visual`` maps an
OpenAI checkpoint's ``visual.*`` names onto them.

The 2x2 pools of a channels_last tensor on the card with gradients disabled
(the frozen trunk of a camera encoder) run in the hand-written kernel
``ops/pool.avg_pool2x2``, which raises on a dtype or width it does not take;
every other pool (the detector's NCHW or trainable tower, the CPU) runs in
``F.avg_pool2d``. Both give the same bits.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.models.resnet import NoBiasConv, TorchBatchNorm, conv_bn, lecun_normal_
from hulc2_torch.ops import pool


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """``F.avg_pool2d(x, k)``; a 2x2 one in the kernel where ``x`` is a
    channels_last tensor on the card and gradients are disabled (the test
    ``models/resnet.conv_bn`` makes for cuDNN's fused path, and the layout)."""
    if (k == 2 and x.is_cuda and not torch.is_grad_enabled()
            and x.is_contiguous(memory_format=torch.channels_last)):
        return pool.avg_pool2x2(x)
    return F.avg_pool2d(x, k)


class LecunLinear(nn.Linear):
    """flax ``nn.Dense``: lecun-normal kernel, zero bias."""

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, generator)
        self.bias.zero_()


class ClipBottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = 4 * features
        self.stride = stride
        self.conv1 = NoBiasConv(cin, features, 1, padding=0)
        self.bn1 = TorchBatchNorm(features)
        self.conv2 = NoBiasConv(features, features, 3)
        self.bn2 = TorchBatchNorm(features)
        self.conv3 = NoBiasConv(features, out, 1, padding=0)
        self.bn3 = TorchBatchNorm(out)
        self.downsample = stride > 1 or cin != out
        if self.downsample:
            self.ds_conv = NoBiasConv(cin, out, 1, padding=0)
            self.ds_bn = TorchBatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn(self.conv1, self.bn1, x, relu=True)
        y = conv_bn(self.conv2, self.bn2, y, relu=True)
        if self.stride > 1:
            y = avg_pool(y, self.stride)
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = avg_pool(identity, self.stride)
            identity = conv_bn(self.ds_conv, self.ds_bn, identity)
        return conv_bn(self.conv3, self.bn3, y, relu=True, residual=identity)


class AttentionPool2d(nn.Module):
    def __init__(self, grid: int, channels: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(grid + 1, channels))
        self.q_proj = LecunLinear(channels, channels)
        self.k_proj = LecunLinear(channels, channels)
        self.v_proj = LecunLinear(channels, channels)
        self.c_proj = LecunLinear(channels, output_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        self.positional_embedding.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, h*w, C), row-major
        if tokens.shape[1] + 1 != self.positional_embedding.shape[0]:
            raise ValueError(f"{tokens.shape[1]} tokens against a positional table of "
                             f"{self.positional_embedding.shape[0] - 1}: the tower was built "
                             "for another input size")
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        hd = c // self.num_heads
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, self.num_heads, hd).transpose(1, 2)
        k = self.k_proj(tokens).reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        v = self.v_proj(tokens).reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-1, -2)).float() / math.sqrt(hd), dim=-1)
        out = (attn.to(v.dtype) @ v).transpose(1, 2).reshape(b, c)
        return self.c_proj(out)


def _stem_hw(hw: int) -> int:
    """Side after the stride-2 3x3 convolution (padding 1) and the 2x2 pool."""
    return ((hw - 1) // 2 + 1) // 2


def attnpool_grid(input_hw: int, n_stages: int = 4) -> int:
    """The attention pool's token count (h*w) for square inputs of ``input_hw``."""
    side = _stem_hw(input_hw)
    for _ in range(n_stages - 1):
        side //= 2
    return side * side


class ClipModifiedResNet(nn.Module):
    """NCHW images -> (embedding (B, output_dim), [stem, layer1..layer4])."""

    def __init__(self, input_hw: int = 224, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 1024, heads: int = 32):
        super().__init__()
        self.layers = tuple(layers)
        w = width
        self.conv1 = NoBiasConv(3, w // 2, 3, 2)
        self.bn1 = TorchBatchNorm(w // 2)
        self.conv2 = NoBiasConv(w // 2, w // 2, 3)
        self.bn2 = TorchBatchNorm(w // 2)
        self.conv3 = NoBiasConv(w // 2, w, 3)
        self.bn3 = TorchBatchNorm(w)
        cin = w
        for stage, n_blocks in enumerate(self.layers):
            features = w * 2 ** stage
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"layer{stage + 1}_{b}", ClipBottleneck(cin, features, stride))
                cin = 4 * features
        self.attnpool = AttentionPool2d(attnpool_grid(input_hw, len(self.layers)), cin, heads,
                                        output_dim)
        self.output_dim = output_dim

    def pyramid(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The prepool feature maps [stem, layer1..layer4], without the pool."""
        y = conv_bn(self.conv1, self.bn1, x, relu=True)
        y = conv_bn(self.conv2, self.bn2, y, relu=True)
        y = conv_bn(self.conv3, self.bn3, y, relu=True)
        y = avg_pool(y, 2)
        feats = [y]
        for stage, n_blocks in enumerate(self.layers):
            for b in range(n_blocks):
                y = getattr(self, f"layer{stage + 1}_{b}")(y)
            feats.append(y)
        return feats

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        feats = self.pyramid(x)
        return self.attnpool(feats[-1]), feats
