"""The affordance package's options on the card against the same code on the CPU.

Torch only, so it runs on a machine with a card and no JAX: ``python -m
pytest --noconftest -m cuda tests/test_torch_port_affordance_options_card.py``.
Every test needs the card and skips without one. Small detectors (decoder
(32, 16, 8, 8, 8), 64 px, 16-d language, batch 2) of each new encoder,
fuser, depth head, label type and the bf16 decoder; fp32 with TF32 off (the
train steps' CPU reference in fp64), the tolerances cover cuDNN's and
oneDNN's other orders of sums.
"""
import numpy as np
import pytest
import torch

from hulc2_torch.affordance.depth_heads import DepthNorm
from hulc2_torch.affordance.detector import AffordancePredictor
from hulc2_torch.affordance.train_affordance import build_detector
from hulc2_torch.configs.affordance import affordance_config
from hulc2_torch.models.resnet import ResNet
from hulc2_torch.tools.profile_affordance import synthetic_train_step
from hulc2_torch.utils.device import set_precision_flags

SMALL = ["aff_detection.decoder_channels=[32,16,8,8,8]", "aff_detection.lang_embed_dim=16",
         "aff_detection.dataset.img_resize.static=64", "batch_size=2"]
OPTIONS = {
    "cross_modal_2d": ("rn18_pixel", ["aff_detection.fusion_type=cross_modal_2d"]),
    "sentence_attention": ("rn18_pixel", ["aff_detection.fusion_type=sentence_attention"]),
    "film": ("rn18_pixel", ["aff_detection.fusion_type=film"]),
    "deep_conv": ("rn18_pixel", ["aff_detection.fusion_type=deep_conv"]),
    "concat": ("rn18_pixel", ["aff_detection.fusion_type=concat"]),
    "rn50 logistic": ("rn50_pixel", []),
    "rn50 trainable": ("rn50_pixel", ["aff_detection.freeze_encoder=false"]),
    "clip": ("clip", []),
    "clip trainable": ("clip", ["aff_detection.freeze_encoder=false"]),
    "r3m trainable": ("r3m_pixel", []),
    "no depth head": ("rn18_pixel", ["aff_detection.depth_dist=null"]),
    "mask": ("rn18_clip_mask", []),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_precision_flags()
    return torch.device("cuda")


def _cfg(group, overrides=()):
    return affordance_config([f"aff_detection={group}", *SMALL, *overrides])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_forward_card_equals_cpu(cuda_device, name):
    """Logits and the depth head's outputs within 1e-3 of the logits' scale."""
    cfg = _cfg(*OPTIONS[name])
    aff = cfg["aff_detection"]
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    lang = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    outs = []
    for d in (torch.device("cpu"), cuda_device):
        model = build_detector(aff, seed=2).to(d).eval()
        with torch.no_grad():
            o = model(img.to(d), lang.to(d))
        outs.append([o.aff_logits.cpu(), *(t.cpu() for t in (o.depth_pred or ()))])
    tol = 1e-3 * max(1.0, outs[0][0].abs().max().item())
    assert len(outs[0]) == len(outs[1]) == (1 if aff["depth_dist"] is None else
                                            4 if aff["depth_dist"] == "logistic" else 3)
    for a, c in zip(*outs):
        torch.testing.assert_close(c, a, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_train_steps_card_equal_cpu(cuda_device, name):
    """Two train steps, same weights, batches and offsets, cuDNN
    deterministic, fp32 on the card: losses within rtol 1e-5 of the CPU's in
    fp64 (the CPU's own fp32 steps part from those by up to 1.06e-5 on a
    CLIP encoder)."""
    cfg = _cfg(*OPTIONS[name])
    torch.backends.cudnn.deterministic = True
    try:
        losses = []
        for d, dtype in ((torch.device("cpu"), torch.float64), (cuda_device, torch.float32)):
            _, step = synthetic_train_step(cfg, d, frame_hw=48, n_batches=2, dtype=dtype)
            losses.append([step()["total_loss"].item() for _ in range(2)])
    finally:
        torch.backends.cudnn.deterministic = False
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


@pytest.mark.cuda
def test_bf16_decoder_card_equals_cpu(cuda_device):
    """The bf16 decoder: two train steps card against CPU within rtol 1e-2,
    and within 5% of the card's fp32 steps; the logits leave fp32."""
    losses = {}
    for tag, ov in (("bf16", ["aff_detection.compute_dtype=bfloat16"]), ("fp32", [])):
        for d in (torch.device("cpu"), cuda_device):
            _, step = synthetic_train_step(_cfg("rn18_pixel", ov), d, frame_hw=48, n_batches=2)
            losses[tag, d.type] = [step()["total_loss"].item() for _ in range(2)]
    np.testing.assert_allclose(losses["bf16", "cuda"], losses["bf16", "cpu"], rtol=1e-2)
    np.testing.assert_allclose(losses["bf16", "cuda"], losses["fp32", "cuda"], rtol=5e-2)
    model = build_detector(_cfg("rn18_pixel", ["aff_detection.compute_dtype=bfloat16"])
                           ["aff_detection"]).to(cuda_device)
    out = model(torch.rand((2, 64, 64, 3), device=cuda_device), torch.rand((2, 16), device=cuda_device))
    assert out.aff_logits.dtype == torch.float32


@pytest.mark.cuda
def test_fused_and_unfused_trunk_paths_agree(cuda_device):
    """A ResNet18 with the same weights, run without a graph (cuDNN's fused
    conv + bias [+ add] + ReLU), with one (the unfused path of a trainable
    trunk) and with frozen_stages=4 (R3M's trainable layer4 on a fused stem
    through layer3): every level within 1e-4 of its scale; only layer4's
    parameters take gradients."""
    torch.manual_seed(3)
    x = torch.rand((2, 3, 64, 64), device=cuda_device)
    trunk = ResNet("resnet18").to(cuda_device)
    r3m = ResNet("resnet18", frozen_stages=4).to(cuda_device)
    r3m.load_state_dict(trunk.state_dict())
    with torch.no_grad():
        fused = trunk(x)
    unfused = trunk(x)
    partly = r3m(x)
    for a, b, c in zip(fused, unfused, partly):
        tol = 1e-4 * max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b.detach(), atol=tol, rtol=0)
        torch.testing.assert_close(c.detach(), b.detach(), atol=tol, rtol=0)
    partly[-1].sum().backward()
    with_grad = {n for n, p in r3m.named_parameters() if p.grad is not None}
    assert with_grad and all(n.startswith("layer4_") for n in with_grad)


@pytest.mark.cuda
def test_logistic_predictor_card_equals_cpu(cuda_device):
    """A logistic-head detector over sentence embeddings through the
    predictor, the same uniforms: pixels where the CPU's top two heatmap
    values are apart, depths within 1e-3."""
    aff = _cfg("rn50_pixel")["aff_detection"]
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (96, 96, 3), np.uint8) for _ in range(3)]
    langs = [rng.standard_normal(16).astype(np.float32) for _ in range(3)]
    model = build_detector(aff, seed=5)
    draws = model.depth_draws(3, torch.Generator().manual_seed(6), "cpu")
    res = {}
    for d in (torch.device("cpu"), cuda_device):
        pred = AffordancePredictor(build_detector(aff, seed=5).to(d), DepthNorm(1.0, 0.1), (64, 64))
        res[d.type] = pred.predict_batch(frames, langs, draws=draws)
    for a, c in zip(res["cpu"], res["cuda"]):
        top2 = np.sort(a["softmax"].ravel())[-2:]
        if top2[1] - top2[0] > 1e-4:
            assert a["pixel"] == c["pixel"]
        np.testing.assert_allclose(c["depth"], a["depth"], atol=1e-3)
