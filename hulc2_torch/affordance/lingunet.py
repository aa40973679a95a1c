"""Language-fused U-Net affordance stream (``hulc2_tpu/affordance/lingunet.py:27-140``).

An encoder pyramid ``[img, stem, layer1..layer4]`` and a U-Net decoder whose
three deepest blocks fuse the language vector: per block, a ``Dense``
projection of the language to the block's input width, the fusion
(``fusion.FUSERS``), a nearest upsample by an integer factor to the skip's
(or the output's) resolution, concatenation with the skip, then two 3x3
conv + BN + ReLU. A 3x3 ``seg_head`` with bias gives one fp32 logit per
pixel. NCHW throughout; the encoder's bottleneck (layer4) is returned for
the depth head.

Encoders (``lingunet.py:112-133``): ``resnet18``/``resnet34``/``resnet50``
(``models/resnet.ResNet``); ``clip_rn50``, CLIP's ModifiedResNet prepool
pyramid with the image prepended (its attention pool is built, as flax
builds it, but not run: nothing reads it; its stem is at stride 4, so the
decoder's last two factors are 1 and 4); ``r3m_rn18``, a ResNet18 whose stem
through layer3 are always frozen and whose layer4 trains when
``freeze_encoder`` is false. A frozen encoder (or stage) runs without a graph
and its parameters take no gradient; a trainable one keeps its stored
BatchNorm statistics (JAX's encoder BatchNorm is inference-style even while
training).

The decoder's BatchNorm is flax's ``nn.BatchNorm(momentum=0.9)``, which is
not ``torch.nn.BatchNorm2d``: in training it normalizes with the batch
statistics and moves its running statistics by ``0.9 * running + 0.1 *
batch`` with the *biased* batch variance, where torch would use the unbiased
one. ``FlaxBatchNorm2d`` does exactly that; in eval mode it uses the running
statistics.

``compute_dtype="bfloat16"`` is JAX's bf16 decoder, done with explicit casts
rather than an autocast: the encoder stays fp32; the decoder's convolutions,
``lang_proj`` and the seg head compute in bf16 from fp32 parameters; each
BatchNorm takes its statistics and normalizes in fp32 and hands on bf16
(flax's ``force_float32_reductions``), its running statistics fp32; the
fusers' own layers compute at the promoted fp32; the logits leave in fp32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.affordance.fusion import FUSERS
from hulc2_torch.models.clip_resnet import ClipModifiedResNet
from hulc2_torch.models.layers import Dense
from hulc2_torch.models.resnet import NoBiasConv, ResNet, lecun_normal_

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's keep rate of the running statistics
ENCODERS = ("resnet18", "resnet34", "resnet50", "clip_rn50", "r3m_rn18")
CLIP_CHANNELS = (3, 64, 256, 512, 1024, 2048)  # [img, stem, layer1..layer4] of RN50


class FlaxBatchNorm2d(nn.Module):
    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return self._normalize(x)
        return self._normalize(x.float()).to(self.dtype)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        # batch statistics, biased variance
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPS)


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    return t if dtype is None or t is None else t.to(dtype)


class Conv2dBNReLU(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = NoBiasConv(cin, features, kernel)
        self.bn = FlaxBatchNorm2d(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(_cast(x, self.dtype), _cast(c.weight, self.dtype), None, c.stride, c.padding)
        return F.relu(self.bn(x))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip_ch: int, out_channels: int, fuse: Optional[str],
                 lang_embed_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fuse, self.dtype = fuse, dtype
        fused_ch = cin
        if fuse is not None:
            self.lang_proj = Dense(lang_embed_dim, cin)
            self.fuser = FUSERS[fuse](cin)
            fused_ch = self.fuser.out_channels(cin)
        self.conv1 = Conv2dBNReLU(fused_ch + skip_ch, out_channels, dtype=dtype)
        self.conv2 = Conv2dBNReLU(out_channels, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, lang: torch.Tensor, skip: Optional[torch.Tensor],
                out_hw: Tuple[int, int]) -> torch.Tensor:
        if self.fuse is not None:
            p = self.lang_proj
            x = self.fuser(x, F.linear(_cast(lang, self.dtype), _cast(p.weight, self.dtype),
                                       _cast(p.bias, self.dtype)))
        factor = (skip.shape[2] if skip is not None else out_hw[0]) // x.shape[2]
        if factor > 1:  # nearest upsample
            x = x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetLangFusionDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], decoder_channels: Sequence[int],
                 fusion_type: str = "mult", lang_embed_dim: int = 1024, n_fused_blocks: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # deepest first, no input echo
        cin, skips = enc[0], enc[1:]
        blocks = []
        for i, ch in enumerate(decoder_channels):
            skip_ch = skips[i] if i < len(skips) else 0
            blocks.append(DecoderBlock(cin, skip_ch, ch, fusion_type if i < n_fused_blocks else None,
                                       lang_embed_dim, dtype))
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


def build_encoder(encoder_name: str, freeze_encoder: bool, input_hw: int):
    """(encoder module, its pyramid's channels [img, stem, layer1..layer4])."""
    if encoder_name == "clip_rn50":
        enc = ClipModifiedResNet(input_hw)
        channels = CLIP_CHANNELS
    elif encoder_name == "r3m_rn18":
        enc = ResNet("resnet18", frozen_stages=5 if freeze_encoder else 4)
        for name, p in enc.named_parameters():
            if not name.startswith("layer4_"):
                p.requires_grad_(False)
        channels = enc.out_channels
    elif encoder_name in ENCODERS:
        enc = ResNet(encoder_name)
        channels = enc.out_channels
    else:
        raise ValueError(f"unknown affordance encoder {encoder_name!r}; known: {ENCODERS}")
    if freeze_encoder:
        enc.requires_grad_(False)
    return enc, tuple(channels)


class LingUNet(nn.Module):
    """encoder pyramid -> language-fused decoder -> per-pixel logits."""

    def __init__(self, decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 fusion_type: str = "mult", lang_embed_dim: int = 1024, n_classes: int = 1,
                 encoder_name: str = "resnet18", freeze_encoder: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, input_hw: int = 224):
        super().__init__()
        self.encoder_name, self.freeze_encoder = encoder_name, freeze_encoder
        self.compute_dtype = compute_dtype
        self.encoder, channels = build_encoder(encoder_name, freeze_encoder, input_hw)
        self.bottleneck_channels = channels[-1]
        self.decoder = UnetLangFusionDecoder(channels, decoder_channels, fusion_type,
                                             lang_embed_dim, dtype=compute_dtype)
        self.seg_head = SegHead(decoder_channels[-1], n_classes, 3, padding=1)

    def encode(self, img: torch.Tensor) -> List[torch.Tensor]:
        if self.encoder_name == "clip_rn50":
            return [img] + self.encoder.pyramid(img)
        return self.encoder(img)

    def forward(self, img: torch.Tensor, lang: torch.Tensor):
        """img (B, 3, H, W) float, lang (B, E) -> (logits (B, 1, H, W) fp32,
        bottleneck (B, C, H/32, W/32))."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_encoder):
            feats = self.encode(img)
        dt, head = self.compute_dtype, self.seg_head
        dec = self.decoder(lang, feats)
        logits = F.conv2d(_cast(dec, dt), _cast(head.weight, dt), _cast(head.bias, dt),
                          head.stride, head.padding)
        return logits.float(), feats[-1]
