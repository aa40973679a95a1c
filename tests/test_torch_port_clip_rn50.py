"""CLIP RN50 on the static camera: the port's ``ClipModifiedResNet``,
``AttentionPool2d`` and ``VisionClip("RN50")`` against the benchmark's
plain reference (``portbench/reference/port/models/clip_resnet.py`` and
``encoders/vision_clip.py``: unfolded convolutions and BatchNorms, a
written-out softmax attention) on seeded random weights, fp32 on the CPU,
at a small size through ``tower_kwargs`` and at 224 px with the published
widths; and the tracer's spans and counter around each camera's encoder and
the frozen trunk in a train step.

Tolerances. The port folds each BatchNorm's scale into the kernel before it
and its shift into the bias (``models/resnet.conv_bn``); the reference
normalises the convolution's output. That reorders fp32 rounding at each
of the tower's 55 convolutions: the outputs differ by ~3e-7 of their
largest magnitude (2.5e-7 at 224, 3.1e-7 at the small size), so the towers
are held to 1e-5 of it (``FOLD``). The attention pool alone has no fold:
the same products in another order, held to 1e-6 (``ATTN``).
"""
from __future__ import annotations

import pytest
import torch

from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.core import trace
from hulc2_torch.models import clip_resnet as port
from hulc2_torch.models.pretrained_vision import VisionClip
from hulc2_torch.training import SyntheticRun
from portbench.reference.port.models import clip_resnet as ref
from portbench.reference.port.models.encoders import vision_clip as ref_encoder

FOLD = 1e-5
ATTN = 1e-6
SMALL = {"layers": (1, 1, 1, 1), "width": 8, "heads": 2, "output_dim": 32}
SIZES = [pytest.param(SMALL, 64, id="small"), pytest.param({}, 224, id="rn50_224")]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _random_state(module: torch.nn.Module, seed: int) -> dict:
    """Every parameter and buffer drawn from the seed: weights of two or more
    dimensions U(+-sqrt(3 / fan_in)), norm scales 1 + U(+-0.1), stored
    variances 1 + U(+-0.5), stored means and biases small."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, v in module.state_dict().items():
        u = torch.rand(v.shape, generator=g) * 2 - 1
        if name.endswith("running_var"):
            out[name] = 1 + 0.5 * u
        elif name.endswith("running_mean"):
            out[name] = 0.1 * u
        elif v.dim() >= 2:
            out[name] = u * (3.0 / v[0].numel()) ** 0.5
        elif name.endswith("weight"):
            out[name] = 1 + 0.1 * u
        else:
            out[name] = 0.05 * u
    return out


def _pair(make_port, make_ref, seed: int = 0):
    """The two modules with the same weights; the reference takes the port's
    state_dict key for key."""
    a, b = make_port(), make_ref()
    state = _random_state(a, seed)
    a.load_state_dict(state)
    b.load_state_dict(state, strict=True)
    return a, b


def _frames(n: int, hw: int, seed: int = 1) -> torch.Tensor:
    return torch.randn(n, 3, hw, hw, generator=torch.Generator().manual_seed(seed))


def _close(got: torch.Tensor, want: torch.Tensor, share: float) -> None:
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= share * scale, (got - want).abs().max().item() / scale


@pytest.mark.parametrize("kw, hw", SIZES)
def test_tower_matches_the_plain_reference(kw, hw):
    tower, plain = _pair(lambda: port.ClipModifiedResNet(hw, **kw),
                         lambda: ref.ClipModifiedResNet(hw, **kw))
    x = _frames(2, hw)
    with torch.no_grad():
        emb, feats = tower(x)
        _close(emb, plain(x), FOLD)
    assert emb.shape == (2, tower.output_dim)
    assert feats[-1].shape[-1] == ref.grid(hw) ** 0.5


def test_rn50_has_the_published_sizes():
    tower = port.ClipModifiedResNet(224)
    assert tower.layers == (3, 4, 6, 3) and tower.output_dim == 1024
    assert tower.attnpool.num_heads == 32 and tower.conv3.out_channels == 64
    assert tower.attnpool.positional_embedding.shape == (7 * 7 + 1, 2048)
    assert sum(p.numel() for p in tower.parameters()) == 38_316_896
    assert len(list(tower.parameters())) == 174
    plain = ref.ClipModifiedResNet(224)
    assert {k: v.shape for k, v in plain.state_dict().items()} == \
        {k: v.shape for k, v in tower.state_dict().items()}


@pytest.mark.parametrize("grid, channels, heads", [(4, 16, 2), (49, 2048, 32)])
def test_attention_pool_alone(grid, channels, heads):
    side = int(grid ** 0.5)
    pool, plain = _pair(lambda: port.AttentionPool2d(grid, channels, heads, 64),
                        lambda: ref.AttentionPool2d(grid, channels, heads, 64))
    x = torch.randn(3, channels, side, side, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _close(pool(x), plain(x), ATTN)


@pytest.mark.parametrize("kw, hw", SIZES)
def test_vision_clip_matches_the_plain_reference(kw, hw):
    cfg = {"_name_": "vision_clip", "visual_features": 64, "model_name": "RN50",
           "freeze_backbone": True, "tower_kwargs": kw}
    encoder, plain = _pair(lambda: VisionClip(hw, visual_features=64, tower_kwargs=kw),
                           lambda: ref_encoder.build(cfg, hw))
    assert encoder.fc1.out_features == plain.fc1.out_features == (512 if not kw else 256)
    x = _frames(3, hw, seed=4)
    with torch.no_grad():
        _close(encoder(x), plain(x), FOLD)


@pytest.mark.parametrize("freeze", [True, False])
def test_freeze_backbone_leaves_the_trunk_without_a_gradient(freeze):
    cfg = {"_name_": "vision_clip", "visual_features": 8, "freeze_backbone": freeze,
           "tower_kwargs": SMALL}
    encoder, plain = _pair(
        lambda: VisionClip(64, visual_features=8, freeze_backbone=freeze, tower_kwargs=SMALL),
        lambda: ref_encoder.build(cfg, 64))
    x = _frames(2, 64, seed=5)
    for module in (encoder, plain):
        module(x).square().sum().backward()
        trunk = [p.grad for p in module.clip.parameters()]
        assert len(trunk) == 66
        assert all(g is None for g in trunk) == freeze
        assert all(g is not None for g in trunk) != freeze
        assert all(p.grad is not None for p in (*module.fc1.parameters(), *module.fc2.parameters()))
    if not freeze:  # the trunk's gradients agree too, against the largest of them all (the
        # key's bias has none to rounding under softmax, so no leaf is its own scale)
        _close(torch.cat([p.grad.reshape(-1) for p in encoder.parameters()]),
               torch.cat([p.grad.reshape(-1) for p in plain.parameters()]), FOLD)


# ---- the tracer's spans around the encoders ---------------------------------- #
TINY = [  # test_torch_port_trace.TINY
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
    "model.language_encoder.width=32", "model.language_encoder.heads=2",
    "datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2",
    "datamodule.min_window_size=4", "datamodule.max_window_size=4",
]
STATIC_CLIP = ["model/perceptual_encoder=static_clip", "datamodule.transforms=clip",
               'model.perceptual_encoder.rgb_static.tower_kwargs='
               '{"layers": [1, 1, 1, 1], "width": 8, "heads": 2, "output_dim": 32}']


@pytest.fixture
def tracer():
    trace.disable()
    trace.drain()
    yield trace
    trace.disable()
    trace.drain()


def _traced_steps(overrides, steps: int = 2) -> dict:
    torch.set_num_threads(1)
    run = SyntheticRun(flagship_config(TINY + overrides), "cpu")
    trace.enable()
    for _ in range(steps):
        run.step(run.next_batch())
    trace.disable()
    return trace.drain()


def test_camera_spans_nest_under_model_encode(tracer):
    got = _traced_steps(STATIC_CLIP)
    spans = got["spans"]
    encode = {s.id: s for s in spans if s.name == "model.encode"}
    assert len(encode) == 2
    for camera in ("rgb_static", "rgb_gripper"):
        mine = [s for s in spans if s.name == f"model.encode.{camera}"]
        assert len(mine) == 2 and all(s.parent in encode for s in mine)
        for s in mine:
            assert encode[s.parent].start_ns <= s.start_ns <= s.end_ns <= encode[s.parent].end_ns
    static = {s.id for s in spans if s.name == "model.encode.rgb_static"}
    trunk = [s for s in spans if s.name == "vision.frozen_trunk"]
    assert len(trunk) == 2 and all(s.parent in static for s in trunk)
    # B * T frames a step: (2 + 2) windows of 4
    assert got["counters"]["vision.frozen_trunk_frames"] == 2 * 4 * 4


def test_the_flagship_has_camera_spans_and_no_trunk(tracer):
    got = _traced_steps([], steps=1)
    names = {s.name for s in got["spans"]}
    assert {"model.encode.rgb_static", "model.encode.rgb_gripper"} <= names
    assert "vision.frozen_trunk" not in names
    assert "vision.frozen_trunk_frames" not in got["counters"]


def test_a_trained_trunk_has_no_frozen_span(tracer):
    got = _traced_steps(STATIC_CLIP + ["model.perceptual_encoder.rgb_static.freeze_backbone=false"],
                        steps=1)
    assert "model.encode.rgb_static" in {s.name for s in got["spans"]}
    assert "vision.frozen_trunk" not in {s.name for s in got["spans"]}
    assert "vision.frozen_trunk_frames" not in got["counters"]


def test_tracing_off_records_nothing(tracer):
    torch.set_num_threads(1)
    run = SyntheticRun(flagship_config(TINY + STATIC_CLIP), "cpu")
    run.step(run.next_batch())
    assert trace.drain() == {"spans": [], "counters": {}}
