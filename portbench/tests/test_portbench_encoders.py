"""The reference finds each camera's encoder by the name in the
configuration: a module of the encoders package is all a new encoder
needs, and a name with no file is refused with its path."""
import sys
import types

import pytest
import torch.nn as nn

from portbench.harness import counts
from portbench.reference.port.data.device_transforms import camera_sizes
from portbench.reference.port.models.build import ENCODERS, build_policy_for
from portbench.tests.tiny import tiny_cell


class _MeanColour(nn.Module):
    """A stand-in encoder: each frame's mean colour through a linear layer."""

    def __init__(self, visual_features: int, hw: int):
        super().__init__()
        self.hw = hw
        self.proj = nn.Linear(3, visual_features)

    def forward(self, x, deterministic=True, generator=None):
        return self.proj(x.float().mean((2, 3)))


def _tiny_cfg(static_name: str) -> dict:
    cfg = tiny_cell("flagship.train.store")["config"]["config"]
    cfg["seed"] = 0
    cfg["model"]["perceptual_encoder"]["rgb_static"]["_name_"] = static_name
    return cfg


def test_an_encoder_module_alone_is_built(monkeypatch):
    """An encoder that exists only as a module under the package's name
    (put into ``sys.modules`` here) is built by ``build_policy_for`` for the
    camera's side after the transform, and its leaves and products reach
    the FLOP count."""
    built = []
    module = types.ModuleType(f"{ENCODERS}.mean_colour")

    def build(cfg, hw):
        built.append((dict(cfg), hw))
        return _MeanColour(cfg["visual_features"], hw)

    module.build = build
    monkeypatch.setitem(sys.modules, module.__name__, module)
    cfg = _tiny_cfg("mean_colour")
    model = build_policy_for(cfg)
    encoder = model.perceptual_encoder.rgb_static_encoder
    hw = camera_sizes(cfg["datamodule"]["transforms"])["rgb_static"]
    assert isinstance(encoder, _MeanColour) and encoder.hw == hw
    assert built == [(cfg["model"]["perceptual_encoder"]["rgb_static"], hw)]
    assert "perceptual_encoder.rgb_static_encoder.proj.weight" in dict(model.named_parameters())
    sides = {"rgb_static": (hw, hw), "rgb_gripper": (64, 64)}
    plain = counts.train_step_flops(_tiny_cfg("vision_network"), sides)
    assert counts.train_step_flops(cfg, sides) < plain  # the stand-in's linear, not the CNN


def test_an_encoder_without_a_file_is_refused():
    with pytest.raises(ValueError, match=r"encoders/no_such_encoder\.py"):
        build_policy_for(_tiny_cfg("no_such_encoder"))


def test_the_two_cnn_encoders_come_from_their_files():
    model = build_policy_for(_tiny_cfg("vision_network"))
    pe = model.perceptual_encoder
    assert type(pe.rgb_static_encoder).__name__ == "VisionNetwork"
    assert type(pe.rgb_gripper_encoder).__name__ == "VisionNetworkGripper"
    for name in ("vision_network", "vision_network_gripper"):
        assert sys.modules[f"{ENCODERS}.{name}"].__file__.endswith(f"encoders/{name}.py")
