"""Per-camera CNN encoders (counterpart of ``hulc2_tpu/models/vision.py``).

Inputs are NCHW float images; the train transform emits NHWC and the
perceptual encoder hands each encoder a ``permute(0, 3, 1, 2)`` view, which is
NCHW in channels_last memory and goes to cuDNN without a copy. The stem is a
plain 8x8 stride-4 conv: the JAX package's space-to-depth packing was a TPU
matrix-unit reparametrization, and ``utils/convert.py`` unpacks its weights.
Module and parameter names are the reference's (``conv_model.0``, ``fc1.0``,
``fc2``, ``ln``), so its state_dict keys carry over.

Options, as in the JAX package: the activation after every conv and the
first FC (``activation_function``), dropout after it (``dropout_vis_fc``),
an L2 normalisation before the LayerNorm (``l2_normalize_output``); the
static encoder's keypoints can be extended by their sine and cosine
(``use_sinusoid``) and its softmax temperature learned
(``spatial_softmax_temp=None``: a parameter of shape (1,), initialised to
one); the gripper encoder's trunk is ``nature_cnn``, ``cnn_3_layers`` or
``cnn_4_layers``.
Every encoder takes its input's channel count (``in_channels``: 3 for RGB,
1 for the depth cameras' encoders).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from portbench.reference.port.models.layers import Conv, Dense, dropout, get_activation, l2_normalize
from portbench.reference.port.ops.spatial import spatial_softmax


def _conv_trunk(act: str, in_channels: int = 3) -> list:
    return [Conv(in_channels, 32, 8, stride=4), get_activation(act), Conv(32, 64, 4, stride=2),
            get_activation(act), Conv(64, 64, 3, stride=1), get_activation(act)]


def _out_hw(hw: int, convs) -> int:
    for k, s in convs:
        hw = (hw - k) // s + 1
    return hw


NATURE_CONVS = ((8, 4), (4, 2), (3, 1))


def nature_cnn(input_hw: int, act: str = "ReLU", in_channels: int = 3) -> nn.Sequential:
    """Nature-DQN trunk -> 128 activated features; the flatten is NCHW, as in
    torch (``vision.py:75``). Indices 0/2/4 are the convs and 7 the linear."""
    flat = 64 * _out_hw(input_hw, NATURE_CONVS) ** 2
    return nn.Sequential(*_conv_trunk(act, in_channels), nn.Flatten(), Dense(flat, 128), get_activation(act))


def small_cnn(input_hw: int, n_convs: int, act: str = "ReLU",
              in_channels: int = 3) -> nn.Sequential:
    """``cnn_3_layers`` (3 convs 3x3 stride 2) or ``cnn_4_layers`` (a fourth
    of stride 1) of 32 channels, NCHW flatten, a linear to 128 without an
    activation (``vision.py:92-123``). Convs at 0, 2, ..., the linear last."""
    convs = [(3, 2)] * 3 + [(3, 1)] * (n_convs - 3)
    layers = []
    for i, (k, s) in enumerate(convs):
        layers += [Conv(in_channels if i == 0 else 32, 32, k, stride=s), get_activation(act)]
    flat = 32 * _out_hw(input_hw, convs) ** 2
    return nn.Sequential(*layers, nn.Flatten(), Dense(flat, 128))


GRIPPER_TRUNKS = {
    "nature_cnn": nature_cnn,
    "cnn_3_layers": lambda hw, act, c: small_cnn(hw, 3, act, c),
    "cnn_4_layers": lambda hw, act, c: small_cnn(hw, 4, act, c),
}


class _Head(nn.Module):
    """fc1 + activation, dropout, fc2 [, L2 normalisation], LayerNorm; made
    after the trunk, so that the init walk draws the trunk first."""

    def make_head(self, in_features: int, visual_features: int, activation_function: str,
                  dropout_vis_fc: float, l2_normalize_output: bool) -> None:
        self.dropout_p = dropout_vis_fc
        self.l2_normalize = l2_normalize_output
        self.fc1 = nn.Sequential(Dense(in_features, 512), get_activation(activation_function))
        self.fc2 = Dense(512, visual_features)
        self.ln = nn.LayerNorm(visual_features, eps=1e-5)

    def head(self, x: torch.Tensor, deterministic: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        x = self.fc2(dropout(self.fc1(x), self.dropout_p, deterministic, generator))
        return self.ln(l2_normalize(x) if self.l2_normalize else x)


class VisionNetwork(_Head):
    """Static-cam encoder: 3 convs, spatial-softmax keypoints (fp32)
    [, their sine and cosine], the head (``vision.py:42``)."""

    def __init__(self, visual_features: int = 64, activation_function: str = "ReLU",
                 dropout_vis_fc: float = 0.0, l2_normalize_output: bool = False,
                 use_sinusoid: bool = False, spatial_softmax_temp: Optional[float] = 1.0,
                 in_channels: int = 3):
        super().__init__()
        self.use_sinusoid = use_sinusoid
        if spatial_softmax_temp is None:
            self.temperature = nn.Parameter(torch.ones(1))
        else:
            self.temperature = float(spatial_softmax_temp)
        self.conv_model = nn.Sequential(*_conv_trunk(activation_function, in_channels))
        self.make_head(384 if use_sinusoid else 128, visual_features, activation_function,
                       dropout_vis_fc, l2_normalize_output)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = spatial_softmax(self.conv_model(x), self.temperature)
        if self.use_sinusoid:
            x = torch.cat([x, torch.sin(x), torch.cos(x)], dim=-1)
        return self.head(x, deterministic, generator)


class VisionNetworkGripper(_Head):
    """Gripper-cam encoder: a selectable trunk, then the head (``vision.py:126``)."""

    def __init__(self, input_hw: int, visual_features: int = 64, conv_encoder: str = "nature_cnn",
                 activation_function: str = "ReLU", dropout_vis_fc: float = 0.0,
                 l2_normalize_output: bool = False, in_channels: int = 3):
        super().__init__()
        if conv_encoder not in GRIPPER_TRUNKS:
            raise ValueError(f"unknown conv_encoder {conv_encoder!r}; known: {sorted(GRIPPER_TRUNKS)}")
        self.conv_model = GRIPPER_TRUNKS[conv_encoder](input_hw, activation_function, in_channels)
        self.make_head(128, visual_features, activation_function, dropout_vis_fc,
                       l2_normalize_output)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head(self.conv_model(x), deterministic, generator)
