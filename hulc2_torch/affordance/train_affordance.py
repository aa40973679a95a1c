"""Affordance detector training (``hulc2_tpu/affordance/train_affordance.py:30-300``).

    python -m hulc2_torch.affordance.train_affordance --run-dir RUN \\
        aff_detection.dataset.data_dir=AFF_DATA [--max-epochs N] [--max-steps K] \\
        [--device cuda|cpu] [key=value ...]
    python -m hulc2_torch.affordance.train_affordance --synthetic --run-dir RUN ...

Trains the ``rn18_tokens_pixel`` detector (``configs/affordance.py``, dotted
overrides) on the labels that ``python -m
hulc2_torch.affordance.dataset_creation`` mined, or with ``--synthetic`` on
random frames. A train step resizes the uint8 frames to the model's input on
the device, crops image and label together by random offsets
(``rand_shift_pad``), runs the forward with the decoder's BatchNorm on batch
statistics, and takes an Adam step (lr 1e-4, betas (0.9, 0.999), eps 1e-8)
on every parameter but the frozen encoder's. Each epoch (batches shuffled
with seed ``seed + epoch``) ends with a validation pass (losses,
``px_dist_err``, ``depth_err``) and a checkpoint in ``RUN/saved_models``;
``RUN/config.json`` holds the config and the labels' ``depth_norm``, which
is what ``evaluate_policy --aff-train-dir RUN`` loads. The crop offsets and
the depth's normal draws come from a generator seeded from ``seed``; the
weights from ``torch.Generator().manual_seed(seed)``.

Runs on the card unless ``--device cpu`` is given, and refuses to run
without one.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hulc2_torch.affordance.dataset import AffordanceDataset, jitter_label_and_image
from hulc2_torch.affordance.depth_heads import DepthNorm
from hulc2_torch.affordance.detector import AffordanceDetector
from hulc2_torch.configs.affordance import affordance_config
from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config
from hulc2_torch.core.metrics import MetricsLogger
from hulc2_torch.data.loader import BatchLoader
from hulc2_torch.models.layers import init_weights_
from hulc2_torch.ops.preprocess import resize
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.utils.clip_tokenizer import CONTEXT_LENGTH, tokenize

logger = logging.getLogger(__name__)


def unported(aff_cfg: dict) -> Optional[str]:
    """What of an ``aff_detection`` config the port cannot build, or None."""
    checks = [
        (aff_cfg.get("encoder_name") == "resnet18", f"encoder {aff_cfg.get('encoder_name')}"),
        (aff_cfg.get("fusion_type") == "mult", f"fusion {aff_cfg.get('fusion_type')}"),
        (aff_cfg.get("depth_dist") == "gaussian", f"depth head {aff_cfg.get('depth_dist')}"),
        (aff_cfg.get("freeze_encoder", True), "a trainable encoder"),
        (aff_cfg.get("text_tower", False), "a detector without the token tower"),
        (not aff_cfg.get("compute_dtype"), "a bf16 decoder"),
        (aff_cfg.get("dataset", {}).get("label_type", "pixel") == "pixel", "mask labels"),
    ]
    missing = [what for ok, what in checks if not ok]
    return f"{', '.join(missing)}: not ported" if missing else None


def build_detector(aff_cfg: dict, seed: int = 42) -> AffordanceDetector:
    """The detector on the CPU, initialised from ``torch.Generator().manual_seed(seed)``."""
    reason = unported(aff_cfg)
    if reason:
        raise NotImplementedError(reason)
    model = AffordanceDetector(aff_cfg["decoder_channels"], aff_cfg["fusion_type"],
                               aff_cfg["lang_embed_dim"], aff_cfg.get("normalize_depth", True),
                               aff_cfg["tower_width"], aff_cfg["tower_heads"], aff_cfg["tower_layers"])
    return init_weights_(model, torch.Generator().manual_seed(seed))


def input_hw(aff_cfg: dict) -> int:
    return aff_cfg["dataset"]["img_resize"][aff_cfg["dataset"]["cam"]]


def _model_imgs(frames: torch.Tensor, img_hw: int) -> torch.Tensor:
    return resize(frames.float() / 255.0, img_hw, img_hw)


def make_aff_train_step(model: AffordanceDetector, optimizer: torch.optim.Optimizer,
                        loss_weights: Dict[str, float], img_hw: int, shift_pad: int):
    """step(batch, offsets) -> metrics (0-d tensors). ``batch`` holds device
    tensors: uint8 frames (B, H, W, 3), px (B, 2) at ``img_hw``, normalized
    depth (B,) and token ids (B, 77); ``offsets`` (B, 2) in [0, 2 pad]."""

    def step(batch: Dict[str, torch.Tensor], offsets: torch.Tensor) -> Dict[str, torch.Tensor]:
        imgs, px = jitter_label_and_image(_model_imgs(batch["frame"], img_hw), batch["px"],
                                          offsets, shift_pad)
        model.train()
        out = model(imgs, batch["lang"])
        total, metrics = model.compute_loss(out, px, batch["normalized_depth"], loss_weights)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_aff_val_step(model: AffordanceDetector, depth_norm: DepthNorm, img_hw: int,
                      loss_weights: Dict[str, float]):
    """step(batch, normal) -> metrics: the losses, the mean pixel distance of
    the argmax to the label and the mean absolute error of the sampled depth
    (normal draws (B, 1))."""

    def step(batch: Dict[str, torch.Tensor], normal: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            out = model(_model_imgs(batch["frame"], img_hw), batch["lang"])
            _, metrics = model.compute_loss(out, batch["px"], batch["normalized_depth"], loss_weights)
            px_pred, depth, _ = model.predict_from_output(out, normal, depth_norm)
            metrics["px_dist_err"] = torch.linalg.norm((px_pred - batch["px"]).float(), dim=-1).mean()
            metrics["depth_err"] = (depth.reshape(-1) - batch["depth"]).abs().mean()
        return metrics

    return step


class SyntheticAffordanceDataset:
    """Shape-correct random affordance items at ``hw`` with token ids."""

    def __init__(self, n: int, hw: int, seed: int = 0):
        self.n, self.hw, self.seed = n, hw, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i))
        px = rng.integers(0, self.hw, 2).astype(np.int32)
        lang = rng.integers(1, 1000, CONTEXT_LENGTH).astype(np.int32)
        return {
            "frame": rng.integers(0, 256, (self.hw, self.hw, 3), np.uint8),
            "px": px,
            "depth": np.float32(rng.uniform(1.3, 4.5)),
            "normalized_depth": np.float32(rng.standard_normal()),
            "lang": lang,
            "idx": np.int64(i),
        }


def to_device(raw: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch on ``device`` (through pinned memory on the card)."""
    out = {}
    for k, v in raw.items():
        if k in ("idx", "lang_ann"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


@dataclass
class AffTrainResult:
    model: AffordanceDetector
    run_dir: Path
    history: List[Dict[str, float]] = field(default_factory=list)  # one line per train step
    val_history: List[Dict[str, float]] = field(default_factory=list)  # one line per epoch
    step: int = 0


def train(overrides: Sequence[str] = (), max_epochs: Optional[int] = None,
          max_steps: Optional[int] = None, synthetic: bool = False, run_dir=None,
          n_synthetic: int = 64, device="cuda") -> AffTrainResult:
    from hulc2_torch.utils.device import resolve_device, set_precision_flags

    device = resolve_device(device)
    set_precision_flags()
    cfg = affordance_config(overrides)
    aff_cfg = cfg["aff_detection"]
    run_dir = Path(run_dir or f"{cfg['log_dir']}/{time.strftime('%Y-%m-%d_%H-%M-%S')}")
    img_hw = input_hw(aff_cfg)
    if synthetic:
        datasets = {s: SyntheticAffordanceDataset(n_synthetic if s == "training" else 8, img_hw, i)
                    for i, s in enumerate(("training", "validation"))}
        depth_norm = DepthNorm()
    else:
        # the token tower embeds the annotations' CLIP-BPE ids inside the step
        ds = aff_cfg["dataset"]
        datasets = {s: AffordanceDataset(ds["data_dir"], s, ds["cam"], img_hw,
                                         ds.get("data_percent", 1.0),
                                         lang_embedder=lambda a: tokenize([a])[0])
                    for s in ("training", "validation")}
        depth_norm = datasets["training"].depth_norm
    # the run dir alone rebuilds the predictor: config + the labels' depth norm
    cfg["depth_norm"] = {"mean": float(depth_norm.mean), "std": float(depth_norm.std)}
    save_run_config(run_dir, cfg)

    model = build_detector(aff_cfg, cfg["seed"]).to(device)
    optimizer = make_optimizer([p for p in model.parameters() if p.requires_grad],
                               aff_cfg["optimizer"])
    loss_weights = aff_cfg["loss_weights"]
    train_step = make_aff_train_step(model, optimizer, loss_weights, img_hw, cfg["rand_shift_pad"])
    val_step = make_aff_val_step(model, depth_norm, img_hw, loss_weights)
    ckpt = CheckpointManager(run_dir)
    mlog = MetricsLogger(run_dir)
    generator = torch.Generator(device=device).manual_seed(cfg["seed"])
    pad = cfg["rand_shift_pad"]
    log_every = 20
    result = AffTrainResult(model, run_dir)
    try:
        for epoch in range(cfg["max_epochs"] if max_epochs is None else max_epochs):
            loader = BatchLoader(datasets["training"], cfg["batch_size"], shuffle=True,
                                 seed=cfg["seed"] + epoch, num_threads=cfg["num_workers"])
            for raw in loader:
                t0 = time.perf_counter()
                batch = to_device(raw, device)
                offsets = torch.randint(0, 2 * pad + 1, (batch["frame"].shape[0], 2),
                                        generator=generator, device=device, dtype=torch.int32)
                metrics = {k: float(v) for k, v in train_step(batch, offsets).items()}
                result.step += 1
                result.history.append({"step": result.step,
                                       "step_ms": 1e3 * (time.perf_counter() - t0), **metrics})
                if result.step % log_every == 0:
                    mlog.log(metrics, result.step, "train/")
                if max_steps and result.step >= max_steps:
                    break
            val = datasets["validation"]
            sums: Dict[str, float] = {}
            n = 0
            if len(val):
                for raw in BatchLoader(val, min(cfg["batch_size"], len(val)), shuffle=False,
                                       num_threads=1):
                    batch = to_device(raw, device)
                    normal = torch.randn((batch["frame"].shape[0], 1), generator=generator,
                                         device=device)
                    for k, v in val_step(batch, normal).items():
                        sums[k] = sums.get(k, 0.0) + float(v)
                    n += 1
            val_metrics = {k: v / max(n, 1) for k, v in sums.items()}
            result.val_history.append(mlog.log(val_metrics, result.step, "val/"))
            logger.info("epoch %d: %s", epoch, {k: round(v, 4) for k, v in val_metrics.items()})
            ckpt.save(result.step, model, optimizer, val_metrics)
            if max_steps and result.step >= max_steps:
                break
    finally:
        mlog.close()
    return result


def main(argv: Optional[Sequence[str]] = None) -> AffTrainResult:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--run-dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="random frames, labels and token ids at the model's input size")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = p.parse_args(argv)
    return train(args.overrides, args.max_epochs, args.max_steps, args.synthetic, args.run_dir,
                 device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main(sys.argv[1:])
