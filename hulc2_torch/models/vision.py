"""Per-camera CNN encoders (counterpart of ``hulc2_tpu/models/vision.py``).

Inputs are NCHW float images; the train transform emits NHWC and the
perceptual encoder hands each encoder a ``permute(0, 3, 1, 2)`` view, which is
NCHW in channels_last memory and goes to cuDNN without a copy. The stem is a
plain 8x8 stride-4 conv: the JAX package's space-to-depth packing was a TPU
matrix-unit reparametrization, and ``utils/convert.py`` unpacks its weights.
Module and parameter names are the reference's (``conv_model.0``, ``fc1.0``,
``fc2``, ``ln``), so its state_dict keys carry over.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from hulc2_torch.models.layers import Conv, Dense, dropout
from hulc2_torch.ops.spatial import spatial_softmax


def _check_flagship_options(activation_function: str, l2_normalize_output: bool) -> None:
    if activation_function != "ReLU" or l2_normalize_output:
        raise NotImplementedError(
            "only activation_function=ReLU and l2_normalize_output=false are ported")


def _conv_trunk() -> list:
    return [Conv(3, 32, 8, stride=4), nn.ReLU(), Conv(32, 64, 4, stride=2), nn.ReLU(),
            Conv(64, 64, 3, stride=1), nn.ReLU()]


def _trunk_out_hw(hw: int) -> int:
    for k, s in ((8, 4), (4, 2), (3, 1)):
        hw = (hw - k) // s + 1
    return hw


class VisionNetwork(nn.Module):
    """Static-cam encoder: 3 convs, spatial-softmax keypoints (fp32), 2 FC,
    LayerNorm -> ``visual_features`` (``vision.py:42``)."""

    def __init__(self, visual_features: int = 64, activation_function: str = "ReLU",
                 dropout_vis_fc: float = 0.0, l2_normalize_output: bool = False,
                 use_sinusoid: bool = False, spatial_softmax_temp: Optional[float] = 1.0):
        super().__init__()
        _check_flagship_options(activation_function, l2_normalize_output)
        if use_sinusoid or spatial_softmax_temp is None:
            raise NotImplementedError("sinusoid features and a learnable temperature are not ported")
        self.temperature = float(spatial_softmax_temp)
        self.dropout_p = dropout_vis_fc
        self.conv_model = nn.Sequential(*_conv_trunk())
        self.fc1 = nn.Sequential(Dense(128, 512), nn.ReLU())
        self.fc2 = Dense(512, visual_features)
        self.ln = nn.LayerNorm(visual_features, eps=1e-5)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = spatial_softmax(self.conv_model(x), self.temperature)
        x = dropout(self.fc1(x), self.dropout_p, deterministic, generator)
        return self.ln(self.fc2(x))


def nature_cnn(input_hw: int) -> nn.Sequential:
    """Nature-DQN trunk -> 128 features; the flatten is NCHW, as in torch
    (``vision.py:75``). Indices 0/2/4 are the convs and 7 the linear."""
    flat = 64 * _trunk_out_hw(input_hw) ** 2
    return nn.Sequential(*_conv_trunk(), nn.Flatten(), Dense(flat, 128), nn.ReLU())


class VisionNetworkGripper(nn.Module):
    """Gripper-cam encoder: nature_cnn trunk, 2 FC, LayerNorm (``vision.py:126``)."""

    def __init__(self, input_hw: int, visual_features: int = 64, conv_encoder: str = "nature_cnn",
                 activation_function: str = "ReLU", dropout_vis_fc: float = 0.0,
                 l2_normalize_output: bool = False):
        super().__init__()
        _check_flagship_options(activation_function, l2_normalize_output)
        if conv_encoder != "nature_cnn":
            raise NotImplementedError(f"conv_encoder {conv_encoder!r} is not ported")
        self.dropout_p = dropout_vis_fc
        self.conv_model = nature_cnn(input_hw)
        self.fc1 = nn.Sequential(Dense(128, 512), nn.ReLU())
        self.fc2 = Dense(512, visual_features)
        self.ln = nn.LayerNorm(visual_features, eps=1e-5)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.fc1(self.conv_model(x)), self.dropout_p, deterministic, generator)
        return self.ln(self.fc2(x))

