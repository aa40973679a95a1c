"""CLIP's ModifiedResNet image tower, plain: fp32 ``Conv2d`` then BatchNorm,
average pools and a softmax attention pool, nothing fused and nothing of
``hulc2_torch``.

Radford et al., *Learning Transferable Visual Models From Natural Language
Supervision*, arXiv 2103.00020; OpenAI ``clip/model.py`` ``ModifiedResNet``,
``Bottleneck`` and ``AttentionPool2d``. "RN50" is layers (3, 4, 6, 3), width
64, 32 heads, a 1024-d embedding, 224 px in:

- the stem: three 3x3 convolutions (the first of stride 2; width / 2, width /
  2, width), each followed by BatchNorm and ReLU, then a 2x2 average pool;
- four stages of bottlenecks (1x1, 3x3, 1x1 to four times the width), the
  first block of stages 2-4 of stride 2; a stride is a 2x2 average pool
  after the 3x3 convolution, and before the downsample's 1x1 convolution
  and BatchNorm, which a block has where it strides or changes width;
- the attention pool: the h*w tokens in row-major order and their mean
  before them, a learned positional table added, one query (the mean
  token) over all h*w + 1 tokens in ``heads`` heads, and a projection to the
  embedding.

Departures from OpenAI's code, none of which changes the function: the
parameter names are the port's (``conv1``, ``bn1``, ``layer1_0.conv1``,
``ds_conv``, ``ds_bn``, ``attnpool.q_proj``), the blocks are flat attributes
and not ``nn.Sequential`` stages; every BatchNorm normalises with its stored
statistics whatever the module's mode (the tower is a frozen pretrained
trunk, which OpenAI's model runs in eval mode; the policy's train mode must
not turn it to batch statistics); the attention is written out as products
and a softmax instead of ``F.multi_head_attention_forward`` (the same
scaled dot product, the query scaled after its product instead of
before); the positional table is sized for the side the tower is built
for (OpenAI's ``input_resolution // 32``, the same at 224); the tower
computes in the input's dtype, not in the weights' (OpenAI casts to its
fp16 checkpoint's). The weights come from the benchmark, so OpenAI's
initialisation is not copied.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm(nn.Module):
    """BatchNorm2d with its stored statistics only, eps 1e-5."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-5)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = 4 * features
        self.stride = stride
        self.conv1, self.bn1 = _conv(cin, features, 1), BatchNorm(features)
        self.conv2, self.bn2 = _conv(features, features, 3), BatchNorm(features)
        self.conv3, self.bn3 = _conv(features, out, 1), BatchNorm(out)
        self.downsample = stride > 1 or cin != out
        if self.downsample:
            self.ds_conv, self.ds_bn = _conv(cin, out, 1), BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = F.avg_pool2d(y, self.stride)
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.ds_bn(self.ds_conv(identity))
        return F.relu(y + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, grid: int, channels: int, heads: int, output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.zeros(grid + 1, channels))
        self.q_proj = nn.Linear(channels, channels)
        self.k_proj = nn.Linear(channels, channels)
        self.v_proj = nn.Linear(channels, channels)
        self.c_proj = nn.Linear(channels, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (N, h*w, C), row-major
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding
        hd = c // self.heads

        def split(t):
            return t.reshape(n, -1, self.heads, hd).transpose(1, 2)  # (N, heads, L, hd)

        q, k, v = split(self.q_proj(tokens[:, :1])), split(self.k_proj(tokens)), \
            split(self.v_proj(tokens))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        return self.c_proj((attn @ v).transpose(1, 2).reshape(n, c))


def grid(side: int, stages: int = 4) -> int:
    """The attention pool's h*w for square inputs of ``side``: the stride-2
    convolution (padding 1), the 2x2 pool, then a halving per later stage."""
    side = ((side - 1) // 2 + 1) // 2
    for _ in range(stages - 1):
        side //= 2
    return side * side


class ClipModifiedResNet(nn.Module):
    """NCHW images of ``input_hw`` -> (N, output_dim)."""

    def __init__(self, input_hw: int = 224, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 1024, heads: int = 32):
        super().__init__()
        self.layers = tuple(layers)
        self.output_dim = output_dim
        self.conv1, self.bn1 = _conv(3, width // 2, 3, 2), BatchNorm(width // 2)
        self.conv2, self.bn2 = _conv(width // 2, width // 2, 3), BatchNorm(width // 2)
        self.conv3, self.bn3 = _conv(width // 2, width, 3), BatchNorm(width)
        cin = width
        for stage, blocks in enumerate(self.layers):
            features = width * 2 ** stage
            for b in range(blocks):
                self.add_module(f"layer{stage + 1}_{b}",
                                Bottleneck(cin, features, 2 if b == 0 and stage > 0 else 1))
                cin = 4 * features
        self.attnpool = AttentionPool2d(grid(input_hw, len(self.layers)), cin, heads, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = F.relu(self.bn3(self.conv3(y)))
        y = F.avg_pool2d(y, 2)
        for stage, blocks in enumerate(self.layers):
            for b in range(blocks):
                y = getattr(self, f"layer{stage + 1}_{b}")(y)
        return self.attnpool(y)
