"""Vision-language fusion (``hulc2_tpu/affordance/fusion.py:20-206``).

Every fuser of the JAX registry, keyed as there (``sent_attn`` is
``sentence_attention``'s second name): ``fuser(x1, x2, mask=None)`` with the
visual map ``x1`` (B, C, H, W) NCHW and the language ``x2`` already
projected to C by the decoder block's ``lang_proj`` (B, C), or, for the word
fusers, per-word (B, T, C) with an optional (B, T) boolean ``mask`` whose
False words get a score of -1e9. Each fuser is built for its block's width
``cin``; ``out_channels(cin)`` is the width it hands on (``concat`` doubles
it). Pixels are taken in row-major (h, w) order, as the NHWC JAX modules
take them.

Precision follows jnp's promotion: the parameter-free fusers compute in the
promoted dtype of their inputs (bf16 only when both are bf16), and the
fusers' own convolutions and Dense layers, built without a dtype in JAX,
compute in fp32 from fp32 parameters.

``word_attention``, ``multi_headed_word_attn`` and ``mult_word`` take per-word
features; the decoder block hands every fuser the (B, E) sentence, so JAX's
detector cannot run them and the port's refuses them (``WORD_FUSERS``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.models.layers import Dense
from hulc2_torch.models.resnet import NoBiasConv, lecun_normal_

WORD_FUSERS = ("word_attention", "mult_word", "multi_headed_word_attn")


def _promoted(*ts: torch.Tensor) -> list:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """A fuser's own layer computes at the promotion of its input and its fp32
    parameters."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _pixels(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major pixels."""
    return x.flatten(2).transpose(1, 2)


def _image(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, H*W, C) -> the (B, C, H, W) layout of ``like``."""
    return flat.transpose(1, 2).reshape(like.shape[0], flat.shape[-1], *like.shape[2:])


def _tile(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return x2[:, :, None, None].expand(-1, -1, *x1.shape[2:])


class FlaxConv(nn.Conv2d):
    """A 3x3 (padding 1) convolution with bias and flax's default init
    (lecun-normal kernel, zero bias)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, generator)
        self.bias.zero_()


class Fuser(nn.Module):
    def __init__(self, cin: int):
        super().__init__()

    @staticmethod
    def out_channels(cin: int) -> int:
        return cin


class FusionAdd(Fuser):
    def forward(self, x1, x2, mask=None):
        return x1 + x2[:, :, None, None]


class FusionMult(Fuser):
    def forward(self, x1, x2, mask=None):
        return x1 * x2[:, :, None, None]


class FusionMax(Fuser):
    def forward(self, x1, x2, mask=None):
        return torch.maximum(x1, x2[:, :, None, None])


class FusionConcat(Fuser):
    @staticmethod
    def out_channels(cin: int) -> int:
        return 2 * cin

    def forward(self, x1, x2, mask=None):
        return torch.cat([x1, _tile(x1, x2)], dim=1)


class FusionConv(Fuser):
    """concat -> ReLU -> 1x1 conv back to ``cin``."""

    kernel = 1

    def __init__(self, cin: int):
        super().__init__(cin)
        self.conv = NoBiasConv(2 * cin, cin, self.kernel)

    def forward(self, x1, x2, mask=None):
        return self.conv(_fp32(F.relu(torch.cat([x1, _tile(x1, x2)], dim=1))))


class FusionConvLat(FusionConv):
    """concat -> ReLU -> 3x3 (lateral) conv back to ``cin``."""

    kernel = 3


class FusionFiLM(Fuser):
    """x1 * (1 + gamma(l)) + beta(l)."""

    def __init__(self, cin: int):
        super().__init__(cin)
        self.gamma = Dense(cin, cin)
        self.beta = Dense(cin, cin)

    def forward(self, x1, x2, mask=None):
        e = _fp32(x2)
        return x1 * (1.0 + self.gamma(e)[:, :, None, None]) + self.beta(e)[:, :, None, None]


class FusionDeepConv(Fuser):
    """concat -> 3x3 conv -> ReLU -> 3x3 conv, both with bias."""

    def __init__(self, cin: int):
        super().__init__(cin)
        self.conv0 = FlaxConv(2 * cin, cin)
        self.conv1 = FlaxConv(cin, cin)

    def forward(self, x1, x2, mask=None):
        cat = _fp32(torch.cat([x1, _tile(x1, x2)], dim=1))
        return self.conv1(F.relu(self.conv0(cat)))


class CrossModalAttention2d(Fuser):
    """Each pixel's query against the sentence's key, a sigmoid score, the
    sentence's value added: x1 + sigmoid(q . k / sqrt(C)) v."""

    def __init__(self, cin: int):
        super().__init__(cin)
        self.q = Dense(cin, cin)
        self.k = Dense(cin, cin)
        self.v = Dense(cin, cin)

    def forward(self, x1, x2, mask=None):
        flat = _fp32(_pixels(x1))
        e = _fp32(x2)
        q, k, v = self.q(flat), self.k(e)[:, None, :], self.v(e)[:, None, :]
        attn = torch.sigmoid(q @ k.transpose(1, 2) / math.sqrt(flat.shape[-1]))
        return _image(flat + attn * v, x1)


class FusionSentenceAttention(Fuser):
    """Scaled-dot scores of the pixels against the sentence, softmaxed over
    the pixels, reweight the features."""

    def forward(self, x1, x2, mask=None):
        flat, e = _promoted(_pixels(x1), x2)
        score = torch.einsum("bpc,bc->bp", flat, e) / math.sqrt(flat.shape[-1])
        return _image(flat * torch.softmax(score, dim=-1)[..., None], x1)


def _masked(score: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return score
    return torch.where(mask, score, torch.full_like(score, -1e9))


class FusionWordAttention(Fuser):
    """The words' dot scores against the pooled visual map, softmaxed over the
    (unmasked) words, give one sentence vector to multiply in. ``x2`` is
    (B, T, C)."""

    scaled = False

    def forward(self, x1, x2, mask=None):
        words, query = _promoted(x2, x1.mean(dim=(2, 3)))
        score = torch.einsum("btc,bc->bt", words, query)
        if self.scaled:
            score = score / math.sqrt(words.shape[-1])
        attn = torch.softmax(_masked(score, mask), dim=-1)
        sentence = torch.einsum("bt,btc->bc", attn, words)
        return x1 * sentence[:, :, None, None]


class FusionMultWord(Fuser):
    """x1 times the mask-averaged words (B, T, C)."""

    def forward(self, x1, x2, mask=None):
        if mask is None:
            mean = x2.mean(dim=1)
        else:
            m = mask.to(x2.dtype)[..., None]
            mean = (x2 * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return x1 * mean[:, :, None, None]


class FusionMultiHeadedWordAttention(Fuser):
    """Pixels attend over the words (B, T, C): softmax(q k^T / sqrt(C)) v added
    to x1. JAX creates ``q{c}``/``k{c}``/``v{c}`` lazily for each channel
    width it meets; a block's fuser meets one, ``cin``, and holds that one."""

    def __init__(self, cin: int):
        super().__init__(cin)
        self.width = cin
        for name in ("q", "k", "v"):
            self.add_module(f"{name}{cin}", Dense(cin, cin))

    def forward(self, x1, x2, mask=None):
        c = self.width
        flat, words = _fp32(_pixels(x1)), _fp32(x2)
        q = getattr(self, f"q{c}")(flat)
        k, v = getattr(self, f"k{c}")(words), getattr(self, f"v{c}")(words)
        score = q @ k.transpose(1, 2) / math.sqrt(c)
        if mask is not None:
            score = _masked(score, mask[:, None, :])
        return _image(flat + torch.softmax(score, dim=-1) @ v, x1)


FUSERS = {
    "add": FusionAdd,
    "mult": FusionMult,
    "max": FusionMax,
    "concat": FusionConcat,
    "conv": FusionConv,
    "conv_lat": FusionConvLat,
    "film": FusionFiLM,
    "deep_conv": FusionDeepConv,
    "word_attention": FusionWordAttention,
    "cross_modal_2d": CrossModalAttention2d,
    "mult_word": FusionMultWord,
    "sentence_attention": FusionSentenceAttention,
    "sent_attn": FusionSentenceAttention,
    "multi_headed_word_attn": FusionMultiHeadedWordAttention,
}
