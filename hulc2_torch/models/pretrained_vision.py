"""Pretrained-architecture vision encoders: R3M, the CLIP image towers, the
tactile streams and the ResNet heads (``hulc2_tpu/models/pretrained_vision.py:25-146``).

Each is a trunk (``models/resnet.ResNet``, ``clip_resnet.ClipModifiedResNet``
or ``clip_vit.ClipVisionTransformer``) and the small trainable FC head the
reference puts on it; NCHW float images in, (N, visual_features) out.
Weights come from random init or from the upstream checkpoints through
``utils/convert`` (``convert_r3m_checkpoint``, ``convert_clip_visual``,
``convert_clip_vit``, ``convert_torchvision_resnet``).

A frozen trunk (``freeze_backbone``; ``VisionResNetAff``'s always) runs
under ``torch.no_grad()``: the JAX modules stop the gradient at the pooled
feature, so nothing before it is differentiated, and the port does not build
that graph; the tracer (``core/trace``) puts it in the span
``vision.frozen_trunk`` and adds its frames to the counter
``vision.frozen_trunk_frames``. Its parameters stay in the model and so in
the optimizer, as they stay in JAX's optax tree: Adam and SGD leave them as
they are, AdamW decays them (``train/steps.make_train_step`` gives a
parameter without a gradient a zero one when the optimizer decays), and the
global norm counts their zero gradients.

``compute_dtype`` (the JAX factories' key) sets the encoder's own
precision on the card: ``float32`` runs it with autocast off, ``bfloat16``
under a bf16 autocast; without it the encoder follows the model's autocast,
as the port's other encoders do.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc2_torch.core import trace
from hulc2_torch.models.layers import Dense
from hulc2_torch.models.resnet import ResNet

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _resnet_side(hw: int, depth: int) -> int:
    """The side of level ``depth`` of [input, stem, layer1..layer4]."""
    if depth == 0:
        return hw
    side = (hw - 1) // 2 + 1  # the 7x7/2 stem
    if depth >= 2:
        side = (side - 1) // 2 + 1  # the 3x3/2 max pool
    for _ in range(3, depth + 1):  # layer2.. each halve
        side = (side - 1) // 2 + 1
    return side


class _Pretrained(nn.Module):
    def __init__(self, freeze_backbone: bool, compute_dtype: Optional[str]):
        super().__init__()
        self.freeze_backbone = freeze_backbone
        self.compute_dtype = None if compute_dtype is None else _DTYPES[compute_dtype]

    def frozen(self, fn, x: torch.Tensor):
        if not self.freeze_backbone:
            return fn(x)
        trace.count("vision.frozen_trunk_frames", x.shape[0])
        with trace.span("vision.frozen_trunk"), torch.no_grad():
            return fn(x)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.compute_dtype is None or x.device.type != "cuda":
            return self.encode(x)
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(device_type="cuda", dtype=torch.bfloat16, enabled=bf16):
            return self.encode(x if bf16 else x.float())


def _head(in_features: int, hidden: int, out: int) -> tuple:
    return Dense(in_features, hidden), Dense(hidden, out)


class VisionR3M(_Pretrained):
    """R3M's ResNet trunk -> global average pool -> relu(fc1 256) -> fc2."""

    def __init__(self, visual_features: int = 64, resnet_model: str = "resnet18",
                 freeze_backbone: bool = True, compute_dtype: Optional[str] = None):
        super().__init__(freeze_backbone, compute_dtype)
        self.r3m = ResNet(resnet_model)
        self.fc1, self.fc2 = _head(self.r3m.out_channels[-1], 256, visual_features)

    def encode(self, x):
        pooled = self.frozen(lambda t: self.r3m(t)[-1].mean(dim=(2, 3)), x)
        return self.fc2(F.relu(self.fc1(pooled)))


class VisionClip(_Pretrained):
    """A CLIP image tower (``model_name`` RN50 or ViT-B/32; ``tower_kwargs``
    override its sizes) -> relu(fc1) -> fc2, fc1 512 wide on a 1024-d
    embedding, else 256. ``input_hw`` is the camera's post-transform size,
    which sizes the tower's positional table."""

    def __init__(self, input_hw: int, visual_features: int = 64, model_name: str = "RN50",
                 freeze_backbone: bool = True, tower_kwargs: Optional[dict] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__(freeze_backbone, compute_dtype)
        kw = dict(tower_kwargs or {})
        if "RN50" in model_name:
            from hulc2_torch.models.clip_resnet import ClipModifiedResNet

            self.clip = ClipModifiedResNet(input_hw, **kw)
            emb = self.clip.output_dim
        elif "ViT" in model_name:
            from hulc2_torch.models.clip_vit import ClipVisionTransformer

            kw.setdefault("input_resolution", input_hw)
            self.clip = ClipVisionTransformer(**kw)
            emb = self.clip.proj.shape[1]
        else:
            raise ValueError(f"unknown CLIP backbone {model_name!r}")
        self.fc1, self.fc2 = _head(emb, 512 if emb == 1024 else 256, visual_features)

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        out = self.clip(x)
        return out[0] if isinstance(out, tuple) else out

    def encode(self, x):
        return self.fc2(F.relu(self.fc1(self.frozen(self._embed, x))))


class TactileEncoder(_Pretrained):
    """One ResNet18 trunk over channels [:3] and [3:] of the 6-channel
    tactile frame (one batch of both), the two pooled features concatenated
    -> relu(fc1 512) -> fc2."""

    def __init__(self, visual_features: int = 64, freeze_backbone: bool = True,
                 compute_dtype: Optional[str] = None):
        super().__init__(freeze_backbone, compute_dtype)
        self.trunk = ResNet("resnet18")
        self.fc1, self.fc2 = _head(2 * 512, 512, visual_features)

    def encode(self, x):
        n = x.shape[0]

        def streams(t):
            pooled = self.trunk(torch.cat([t[:, :3], t[:, 3:]], dim=0))[-1].mean(dim=(2, 3))
            return torch.cat([pooled[:n], pooled[n:]], dim=-1)

        return self.fc2(F.relu(self.fc1(self.frozen(streams, x))))


class VisionResNet(_Pretrained):
    """A ResNet18 trunk (trained unless ``freeze_backbone``) -> global
    average pool -> relu(fc1 256) -> fc2."""

    def __init__(self, visual_features: int = 64, freeze_backbone: bool = False,
                 compute_dtype: Optional[str] = None):
        super().__init__(freeze_backbone, compute_dtype)
        self.resnet = ResNet("resnet18")
        self.fc1, self.fc2 = _head(512, 256, visual_features)

    def encode(self, x):
        pooled = self.frozen(lambda t: self.resnet(t)[-1].mean(dim=(2, 3)), x)
        return self.fc2(F.relu(self.fc1(pooled)))


class VisionResNetAff(_Pretrained):
    """A frozen ResNet18 trunk cut after level ``depth`` (3: layer2, stride
    8), its map flattened in NHWC order as the JAX module flattens it ->
    relu(fc1 512) -> relu(fc2 256) -> fc3. The trunk holds every stage (the
    JAX module's unused stages have parameters too) and runs to ``depth``.
    ``freeze_backbone`` is accepted and, as in JAX, changes nothing."""

    def __init__(self, input_hw: int, visual_features: int = 64, depth: int = 3,
                 freeze_backbone: bool = True, compute_dtype: Optional[str] = None):
        super().__init__(True, compute_dtype)
        self.depth = depth
        self.resnet = ResNet("resnet18")
        flat = self.resnet.out_channels[depth] * _resnet_side(input_hw, depth) ** 2
        self.fc1 = Dense(flat, 512)
        self.fc2 = Dense(512, 256)
        self.fc3 = Dense(256, visual_features)

    def encode(self, x):
        y = self.frozen(lambda t: self.resnet(t, self.depth)[self.depth], x)
        h = F.relu(self.fc1(y.permute(0, 2, 3, 1).flatten(1)))
        return self.fc3(F.relu(self.fc2(h)))
