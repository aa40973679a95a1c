"""Affordance detector training (``hulc2_tpu/affordance/train_affordance.py:30-300``).

    python -m hulc2_torch.affordance.train_affordance --run-dir RUN \\
        aff_detection.dataset.data_dir=AFF_DATA [--max-epochs N] [--max-steps K] \\
        [--device cuda|cpu] [key=value ...]
    python -m hulc2_torch.affordance.train_affordance --synthetic --run-dir RUN ...

Trains the detector of ``configs/affordance.py`` (``rn18_tokens_pixel`` unless
``aff_detection=<group>`` names another of the twelve groups; dotted
overrides, e.g. ``aff_detection.compute_dtype=bfloat16`` for the bf16
decoder) on the labels that ``python -m
hulc2_torch.affordance.dataset_creation`` mined, or with ``--synthetic`` on
random frames. A token-tower detector embeds the annotations' CLIP-BPE ids
inside the step; any other takes ``hash_embed`` sentence embeddings at its
``lang_embed_dim``, a stand-in allowed only with
``HULC2_ALLOW_STUB_EMBEDDINGS=1`` (``tools/auto_lang_annotator``). A train
step resizes the uint8 frames to the model's input on the device, crops
image and label (and with ``label_type=mask`` the mask) together by random
offsets (``rand_shift_pad``), runs the forward with the decoder's BatchNorm
on batch statistics, and takes a step of the config's optimizer (Adam, lr
1e-4, betas (0.9, 0.999), eps 1e-8) on every parameter; a frozen encoder or
stage takes no gradient (an optimizer that decays its weights decays it, as
optax does). Each epoch (batches shuffled with seed ``seed + epoch``) ends
with a validation pass (losses, ``px_dist_err``, ``depth_err`` with a depth
head) and a checkpoint in ``RUN/saved_models``; ``RUN/config.json`` holds the
config and the labels' ``depth_norm``, which is what ``evaluate_policy
--aff-train-dir RUN`` loads. The crop offsets and the depth head's draws come
from a generator seeded from ``seed``; the weights from
``torch.Generator().manual_seed(seed)``.

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
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hulc2_torch.affordance.dataset import (
    AffordanceDataset,
    jitter_label_and_image,
    jitter_mask_and_image,
)
from hulc2_torch.affordance.depth_heads import DepthNorm
from hulc2_torch.affordance.detector import AffordanceDetector
from hulc2_torch.configs.affordance import affordance_config
from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config
from hulc2_torch.core.metrics import MetricsLogger
from hulc2_torch.data.loader import BatchLoader
from hulc2_torch.models.layers import init_weights_
from hulc2_torch.ops.preprocess import resize
from hulc2_torch.tools.auto_lang_annotator import hash_embed, require_stub_embeddings_ok
from hulc2_torch.train.optim import make_optimizer
from hulc2_torch.utils.clip_tokenizer import CONTEXT_LENGTH, tokenize

logger = logging.getLogger(__name__)


def build_detector(aff_cfg: dict, seed: int = 42) -> AffordanceDetector:
    """The detector of any ``aff_detection`` group on the CPU, initialised from
    ``torch.Generator().manual_seed(seed)``."""
    model = AffordanceDetector(
        aff_cfg["decoder_channels"], aff_cfg["fusion_type"], aff_cfg["lang_embed_dim"],
        aff_cfg.get("normalize_depth", True), aff_cfg.get("tower_width", 256),
        aff_cfg.get("tower_heads", 4), aff_cfg.get("tower_layers", 2),
        encoder_name=aff_cfg["encoder_name"], depth_dist=depth_dist(aff_cfg),
        freeze_encoder=aff_cfg.get("freeze_encoder", True),
        compute_dtype=aff_cfg.get("compute_dtype") or None,
        text_tower=aff_cfg.get("text_tower", False), input_hw=input_hw(aff_cfg))
    return init_weights_(model, torch.Generator().manual_seed(seed))


def depth_dist(aff_cfg: dict) -> Optional[str]:
    """The depth head's kind, None for ``null`` or ``none`` (JAX's factory
    takes only ``null`` for no head)."""
    dist = aff_cfg.get("depth_dist")
    return None if dist in (None, "", "none") else dist


def label_type(aff_cfg: dict) -> str:
    return aff_cfg["dataset"].get("label_type", "pixel")


def input_hw(aff_cfg: dict) -> int:
    return aff_cfg["dataset"]["img_resize"][aff_cfg["dataset"]["cam"]]


def _model_imgs(frames: torch.Tensor, img_hw: int, model: AffordanceDetector) -> torch.Tensor:
    """uint8 frames -> [0, 1] images at ``img_hw`` (resized in fp32) in the
    precision of the model's parameters."""
    return resize(frames.float() / 255.0, img_hw, img_hw).to(next(model.parameters()).dtype)


def make_aff_train_step(model: AffordanceDetector, optimizer: torch.optim.Optimizer,
                        loss_weights: Dict[str, float], img_hw: int, shift_pad: int,
                        labels: str = "pixel"):
    """step(batch, offsets) -> metrics (0-d tensors). ``batch`` holds device
    tensors: uint8 frames (B, H, W, 3), px (B, 2) at ``img_hw``, normalized
    depth (B,), the language input (token ids (B, 77) or embeddings (B, E))
    and, with ``labels="mask"``, the mask (B, img_hw, img_hw); ``offsets``
    (B, 2) in [0, 2 pad]."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    # optax decays every parameter, a frozen one too; torch skips a parameter
    # whose .grad is None
    zero_fill = any(g.get("weight_decay", 0.0) for g in optimizer.param_groups)

    def step(batch: Dict[str, torch.Tensor], offsets: torch.Tensor) -> Dict[str, torch.Tensor]:
        imgs = _model_imgs(batch["frame"], img_hw, model)
        if labels == "mask":
            imgs, mask, px = jitter_mask_and_image(imgs, batch["mask"], batch["px"], offsets,
                                                   shift_pad)
        else:
            imgs, px = jitter_label_and_image(imgs, batch["px"], offsets, shift_pad)
        model.train()
        out = model(imgs, batch["lang"])
        if labels == "mask":
            total, metrics = model.compute_mask_loss(out, mask, batch["normalized_depth"],
                                                     loss_weights)
        else:
            total, metrics = model.compute_loss(out, px, batch["normalized_depth"], loss_weights)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if zero_fill:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_aff_val_step(model: AffordanceDetector, depth_norm: DepthNorm, img_hw: int,
                      loss_weights: Dict[str, float], labels: str = "pixel"):
    """step(batch, draws) -> metrics: the losses, the mean pixel distance of
    the argmax to the label and, with a depth head, the mean absolute error of
    the depth sampled from ``draws`` (``AffordanceDetector.depth_draws``)."""

    def step(batch: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            out = model(_model_imgs(batch["frame"], img_hw, model), batch["lang"])
            if labels == "mask":
                _, metrics = model.compute_mask_loss(out, batch["mask"], batch["normalized_depth"],
                                                     loss_weights)
            else:
                _, metrics = model.compute_loss(out, batch["px"], batch["normalized_depth"],
                                                loss_weights)
            px_pred, depth, _ = model.predict_from_output(out, draws, depth_norm)
            metrics["px_dist_err"] = torch.linalg.norm((px_pred - batch["px"]).float(), dim=-1).mean()
            if depth is not None:
                metrics["depth_err"] = (depth.reshape(-1) - batch["depth"]).abs().mean()
        return metrics

    return step


class SyntheticAffordanceDataset:
    """Shape-correct random affordance items at ``hw``: token ids or
    ``lang_dim`` float embeddings, and with ``label_type="mask"`` a disc mask
    of radius hw // 10 around the label."""

    def __init__(self, n: int, hw: int, lang_dim: int, seed: int = 0,
                 label_type: str = "pixel", lang_tokens: bool = False):
        self.n, self.hw, self.lang_dim, self.seed = n, hw, lang_dim, seed
        self.label_type, self.lang_tokens = label_type, lang_tokens

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i))
        px = rng.integers(0, self.hw, 2).astype(np.int32)
        lang = (rng.integers(1, 1000, CONTEXT_LENGTH).astype(np.int32) if self.lang_tokens
                else rng.standard_normal(self.lang_dim).astype(np.float32))
        out = {
            "frame": rng.integers(0, 256, (self.hw, self.hw, 3), np.uint8),
            "px": px,
            "depth": np.float32(rng.uniform(1.3, 4.5)),
            "normalized_depth": np.float32(rng.standard_normal()),
            "lang": lang,
            "idx": np.int64(i),
        }
        if self.label_type == "mask":
            yy, xx = np.ogrid[: self.hw, : self.hw]
            out["mask"] = (((yy - px[0]) ** 2 + (xx - px[1]) ** 2)
                           <= (self.hw // 10) ** 2).astype(np.float32)
        return out


def language_embedder(aff_cfg: dict) -> Callable[[str], np.ndarray]:
    """Annotation -> the detector's language input: CLIP-BPE token ids for the
    token tower; else the ``hash_embed`` sentence embedding at
    ``lang_embed_dim``, behind the stub-embedding gate."""
    if aff_cfg.get("text_tower"):
        return lambda a: tokenize([a])[0]
    require_stub_embeddings_ok("train_affordance")
    dim = aff_cfg["lang_embed_dim"]
    return lambda a: hash_embed([a], dim)[0]


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
    labels = label_type(aff_cfg)
    if synthetic:
        datasets = {s: SyntheticAffordanceDataset(n_synthetic if s == "training" else 8, img_hw,
                                                  aff_cfg["lang_embed_dim"], i, labels,
                                                  aff_cfg.get("text_tower", False))
                    for i, s in enumerate(("training", "validation"))}
        depth_norm = DepthNorm()
    else:
        ds = aff_cfg["dataset"]
        embedder = language_embedder(aff_cfg)
        datasets = {s: AffordanceDataset(ds["data_dir"], s, ds["cam"], img_hw,
                                         ds.get("data_percent", 1.0), lang_embedder=embedder,
                                         label_type=labels)
                    for s in ("training", "validation")}
        depth_norm = datasets["training"].depth_norm
    # the run dir alone rebuilds the predictor: config + the labels' depth norm
    cfg["depth_norm"] = {"mean": float(depth_norm.mean), "std": float(depth_norm.std)}
    save_run_config(run_dir, cfg)

    model = build_detector(aff_cfg, cfg["seed"]).to(device)
    optimizer = make_optimizer(model.parameters(), aff_cfg["optimizer"])
    loss_weights = aff_cfg["loss_weights"]
    train_step = make_aff_train_step(model, optimizer, loss_weights, img_hw, cfg["rand_shift_pad"],
                                     labels)
    val_step = make_aff_val_step(model, depth_norm, img_hw, loss_weights, labels)
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
                    draws = model.depth_draws(batch["frame"].shape[0], generator, device)
                    for k, v in val_step(batch, draws).items():
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
                   help="random frames, labels and language inputs at the model's input size")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = p.parse_args(argv)
    return train(args.overrides, args.max_epochs, args.max_steps, args.synthetic, args.run_dir,
                 device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main(sys.argv[1:])
