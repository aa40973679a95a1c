"""Language-fused U-Net affordance stream (``hulc2_tpu/affordance/lingunet.py:27-140``).

A frozen ResNet18 pyramid and a U-Net decoder whose three deepest blocks
fuse the language vector: per block, a ``Dense`` projection of the language
to the block's input width, the fusion, a nearest upsample by an integer
factor to the skip's (or the output's) resolution, concatenation with the
skip, then two 3x3 conv + BN + ReLU. A 3x3 ``seg_head`` with bias gives one
fp32 logit per pixel. NCHW throughout; the encoder's bottleneck (layer4) is
returned for the depth head.

The decoder's BatchNorm is flax's ``nn.BatchNorm(momentum=0.9)``, which is
not ``torch.nn.BatchNorm2d``: in training it normalizes with the batch
statistics and moves its running statistics by ``0.9 * running + 0.1 *
batch`` with the *biased* batch variance, where torch would use the unbiased
one. ``FlaxBatchNorm2d`` does exactly that; in eval mode it uses the running
statistics.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.affordance.fusion import FUSERS
from hulc2_torch.models.layers import Dense
from hulc2_torch.models.resnet import NoBiasConv, ResNet18, lecun_normal_

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's keep rate of the running statistics


class FlaxBatchNorm2d(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        # batch statistics, biased variance
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPS)


class Conv2dBNReLU(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        self.conv = NoBiasConv(cin, features, kernel)
        self.bn = FlaxBatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip_ch: int, out_channels: int, fuse: Optional[str],
                 lang_embed_dim: int):
        super().__init__()
        self.fuse = fuse
        if fuse is not None:
            self.lang_proj = Dense(lang_embed_dim, cin)
            self.fuser = FUSERS[fuse]()
        self.conv1 = Conv2dBNReLU(cin + skip_ch, out_channels)
        self.conv2 = Conv2dBNReLU(out_channels, out_channels)

    def forward(self, x: torch.Tensor, lang: torch.Tensor, skip: Optional[torch.Tensor],
                out_hw: Tuple[int, int]) -> torch.Tensor:
        if self.fuse is not None:
            x = self.fuser(x, self.lang_proj(lang))
        factor = (skip.shape[2] if skip is not None else out_hw[0]) // x.shape[2]
        if factor > 1:  # nearest upsample
            x = x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetLangFusionDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], decoder_channels: Sequence[int],
                 fusion_type: str = "mult", lang_embed_dim: int = 1024, n_fused_blocks: int = 3):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # deepest first, no input echo
        cin, skips = enc[0], enc[1:]
        blocks = []
        for i, ch in enumerate(decoder_channels):
            skip_ch = skips[i] if i < len(skips) else 0
            blocks.append(DecoderBlock(cin, skip_ch, ch, fusion_type if i < n_fused_blocks else None,
                                       lang_embed_dim))
            cin = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, lang: torch.Tensor, features: List[torch.Tensor]) -> torch.Tensor:
        out_hw = tuple(features[0].shape[2:])
        feats = features[1:][::-1]
        x, skips = feats[0], feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, lang, skips[i] if i < len(skips) else None, out_hw)
        return x


class SegHead(nn.Conv2d):
    """3x3 conv with bias, flax's default init (lecun-normal kernel, zero bias)."""

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, generator)
        self.bias.zero_()


class LingUNet(nn.Module):
    """encoder pyramid -> language-fused decoder -> per-pixel logits. The
    encoder is frozen: it runs without autograd and its parameters take no
    gradient."""

    bottleneck_channels = ResNet18.out_channels[-1]

    def __init__(self, decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 fusion_type: str = "mult", lang_embed_dim: int = 1024, n_classes: int = 1):
        super().__init__()
        self.encoder = ResNet18().requires_grad_(False)
        self.decoder = UnetLangFusionDecoder(ResNet18.out_channels, decoder_channels, fusion_type,
                                             lang_embed_dim)
        self.seg_head = SegHead(decoder_channels[-1], n_classes, 3, padding=1)

    def forward(self, img: torch.Tensor, lang: torch.Tensor):
        """img (B, 3, H, W) float, lang (B, E) -> (logits (B, 1, H, W) fp32,
        bottleneck (B, 512, H/32, W/32))."""
        with torch.no_grad():
            feats = self.encoder(img)
        logits = self.seg_head(self.decoder(lang, feats))
        return logits.float(), feats[-1]
