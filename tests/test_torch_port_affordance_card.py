"""The affordance detector on the card against the same code on the CPU.

Torch only, so it runs on a machine with a card and no JAX: ``python -m
pytest --noconftest -m cuda tests/test_torch_port_affordance_card.py``.
Every test needs the card and skips without one. fp32 on both sides with
TF32 off; the tolerances cover cuDNN's and oneDNN's other orders of sums.
"""
import numpy as np
import pytest
import torch

from hulc2_torch.affordance.depth_heads import DepthNorm
from hulc2_torch.affordance.detector import AffordancePredictor
from hulc2_torch.affordance.train_affordance import (
    SyntheticAffordanceDataset,
    build_detector,
    make_aff_train_step,
    train,
)
from hulc2_torch.configs.affordance import affordance_config
from hulc2_torch.data.loader import collate
from hulc2_torch.ops.preprocess import resize
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.utils.device import set_precision_flags

SMALL = ["aff_detection.decoder_channels=[32,16,8,8,8]", "aff_detection.tower_width=32",
         "aff_detection.tower_heads=2", "aff_detection.dataset.img_resize.static=64"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_precision_flags()
    return torch.device("cuda")


def _batch(n, hw, seed):
    items = [SyntheticAffordanceDataset(n, hw, seed)[i] for i in range(n)]
    return {k: torch.from_numpy(v) for k, v in collate(items).items() if k != "idx"}


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [(96, 224), (224, 96), (48, 64)])
def test_resize_card_equals_cpu(cuda_device, src, dst):
    x = torch.rand((4, src, src, 3), generator=torch.Generator().manual_seed(src + dst))
    got = resize(x.to(cuda_device), dst, dst).cpu()
    torch.testing.assert_close(got, resize(x, dst, dst), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [SMALL, []], ids=["small", "full"])
def test_detector_card_equals_cpu(cuda_device, overrides):
    """Logits, mu and sigma within 1e-3 of the largest logit's magnitude."""
    cfg = affordance_config(overrides)
    hw = cfg["aff_detection"]["dataset"]["img_resize"]["static"]
    b = _batch(4, hw, seed=1)
    imgs = b["frame"].float() / 255.0
    outs = []
    for d in (torch.device("cpu"), cuda_device):
        model = build_detector(cfg["aff_detection"], seed=3).to(d).eval()
        with torch.no_grad():
            o = model(imgs.to(d), b["lang"].to(d))
        outs.append([o.aff_logits.cpu(), *(t.cpu() for t in o.depth_pred)])
    tol = 1e-3 * max(1.0, outs[0][0].abs().max().item())
    for a, c in zip(*outs):
        torch.testing.assert_close(c, a, atol=tol, rtol=0)


@pytest.mark.cuda
def test_train_steps_card_equal_cpu(cuda_device):
    """Two train steps, same weights, batches and offsets: losses within rtol
    1e-3, the encoder unchanged on the card."""
    cfg = affordance_config(SMALL)
    aff, pad = cfg["aff_detection"], cfg["rand_shift_pad"]
    batches = [_batch(4, 48, seed=s) for s in (4, 5)]
    for b in batches:
        b["px"] = (b["px"] * 64 // 48).int()
    offsets = [torch.randint(0, 2 * pad + 1, (4, 2), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(s)) for s in (6, 7)]
    losses = {}
    for d in (torch.device("cpu"), cuda_device):
        model = build_detector(aff, seed=8).to(d)
        before = {k: v.clone() for k, v in model.aff_stream.encoder.state_dict().items()}
        opt = make_optimizer([p for p in model.parameters() if p.requires_grad], aff["optimizer"])
        step = make_aff_train_step(model, opt, aff["loss_weights"], 64, pad)
        losses[d.type] = [step({k: v.to(d) for k, v in b.items()}, o.to(d))["total_loss"].item()
                          for b, o in zip(batches, offsets)]
        for k, v in model.aff_stream.encoder.state_dict().items():
            assert torch.equal(v, before[k]), k
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)


@pytest.mark.cuda
def test_predictor_card_equals_cpu(cuda_device):
    """Frames of 96 px at the full width's 224: equal pixels wherever the
    CPU's top two heatmap values are apart, depths within 1e-3."""
    cfg = affordance_config()
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (96, 96, 3), np.uint8) for _ in range(4)]
    langs = list(_batch(4, 8, seed=10)["lang"].numpy())
    normal = torch.randn((4, 1), generator=torch.Generator().manual_seed(11))
    res = {}
    for d in (torch.device("cpu"), cuda_device):
        pred = AffordancePredictor(build_detector(cfg["aff_detection"], seed=12).to(d),
                                   DepthNorm(1.0, 0.1), (224, 224))
        res[d.type] = pred.predict_batch(frames, langs, normal=normal)
    for a, c in zip(res["cpu"], res["cuda"]):
        top2 = np.sort(a["softmax"].ravel())[-2:]
        if top2[1] - top2[0] > 1e-4:
            assert a["pixel"] == c["pixel"]
        np.testing.assert_allclose(c["depth"], a["depth"], atol=1e-3)
        np.testing.assert_allclose(c["softmax"], a["softmax"], atol=1e-4)


def _train_twice(tmp_path, tag):
    runs = [train(max_steps=3, synthetic=True, run_dir=tmp_path / f"{tag}{i}", device="cuda")
            for i in range(2)]
    a, b = (r.model.state_dict() for r in runs)
    gap = max((a[k].double() - b[k].double()).abs().max().item() for k in a)
    return runs, sum(not torch.equal(a[k], b[k]) for k in a), gap


@pytest.mark.cuda
def test_detector_training_repeats_bit_for_bit(cuda_device, tmp_path, monkeypatch):
    """The full-width detector trained twice in one process from one seed
    (``train_affordance.train --synthetic``, 3 steps at batch 32 over 2
    epochs, each with a validation): with cuDNN's deterministic algorithms
    and no autotuning, every parameter and BatchNorm statistic, every loss
    and every val metric is bit-equal, so the trainer has no unseeded draw.
    The same twice with the default settings prints the gap it leaves."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    runs, differ, gap = _train_twice(tmp_path, "det")
    assert differ == 0 and gap == 0.0
    assert runs[0].history[-1]["step"] == 3
    for key in ("history", "val_history"):
        strip = [[{k: v for k, v in line.items() if k not in ("step_ms", "time")}
                  for line in getattr(r, key)]
                 for r in runs]
        assert strip[0] == strip[1]
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    _, differ, gap = _train_twice(tmp_path, "default")
    n = len(runs[0].model.state_dict())
    print(f"[determinism] default cuDNN settings: {differ} of {n} tensors differ between two "
          f"runs, max abs gap {gap:.3g}; deterministic: 0 of {n}")
