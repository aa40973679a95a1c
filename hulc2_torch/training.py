"""Policy training entry point of the port.

    python -m hulc2_torch.training --run-dir DIR [--config-name cfg_low_level [--shm-cache]]
        [--max-epochs N] [--max-steps K] [--device cuda|cpu]
        datamodule.root_data_dir=DATASET [key=value ...]
    python -m hulc2_torch.training --synthetic --max-steps 3 [--device cuda|cpu]
        [--run-dir DIR] [key=value ...]
    torchrun --nproc_per_node N -m hulc2_torch.training --run-dir DIR
        datamodule.root_data_dir=DATASET [key=value ...]

Without ``--config-name`` it builds the flagship policy
(``configs/flagship.py``); with it, the registry's root of that name
(``configs/policy.py``; the JAX package's default is ``cfg_low_level``).
Dotted ``key=value`` overrides and ``group/option=name`` swaps apply, e.g.
``trainer.limit_val_batches=6``, ``model.plan_proposal.hidden_size=64``,
``seed=3`` or ``model/language_encoder=clip_scratch``.

From disk (``datamodule.root_data_dir``, a dataset written by
``python -m hulc2_torch.tools.make_expert_dataset``), ``train/trainer.py``
trains, validates every epoch and checkpoints into
``<run-dir>/saved_models``; the run dir's ``config.json`` and checkpoints are
what ``evaluate_policy --train-dir`` loads. Run again with more epochs, it
resumes from its newest checkpoint. With ``datamodule.device_store=true``
(the flagship) the training split's frames are resident on the device; with
``false`` (``cfg_low_level``) each batch is assembled on the host from the
npz files through the native loader, or with ``--shm-cache`` from a
shared-memory cache of the split.

The trainer runs the callbacks of ``callbacks.rollout_lh``,
``callbacks.rollout`` and ``callbacks.tsne_plot`` (``train/callback_factory.py``)
after each validation, keeps checkpoints by ``callbacks/checkpoint=<preset>``
and logs to the sinks of ``logger=jsonl|tb|wandb``. A text-tower policy's
rollout goals are token ids; an embedding policy's come from the dataset's
``validation/<lang_folder>/embeddings.npy`` (``hulc2_tpu/training.py:56-71``).

Under ``torchrun`` each process is one data-parallel rank: it starts the
process group (``nccl`` on the card, ``gloo`` with ``--device cpu``),
trains on ``cuda:LOCAL_RANK`` unless ``--device`` says otherwise, and takes
its shard of every epoch's batches (``parallel/mesh.py``).

``--synthetic`` takes ``--max-steps`` fused train steps on synthetic windows
made on the device, without validation or checkpoints. Each step appends one
line to ``<run-dir>/metrics.jsonl`` with its losses and its wall time (host
clock around the step, ending in a device synchronise).
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.core.config import compose, options
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.device_transforms import camera_sizes, make_batch_transform
from hulc2_torch.data.random_data import RandomWindowBatches
from hulc2_torch.models.build import build_policy_for
from hulc2_torch.models.clip_text import ClipTextTransformer
from hulc2_torch.models.hulc2 import Hulc2
from hulc2_torch.parallel.mesh import (initialize_distributed, launched_by_torchrun, local_rank,
                                       process_count, process_index)
from hulc2_torch.train.callback_factory import build_callbacks
from hulc2_torch.train.optim import make_optimizer, make_scheduler
from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step
from hulc2_torch.train.trainer import FitResult, Trainer
from hulc2_torch.utils.device import resolve_device, set_precision_flags


@dataclass
class TrainResult:
    model: Hulc2
    history: List[Dict[str, float]] = field(default_factory=list)


class SyntheticRun:
    """The policy of ``cfg``, its optimizer, transform, train step and a source
    of synthetic batches on ``device``; ``step(raw, eager=False)`` takes one
    train step on a batch from ``data`` (with ``eager``, not a replay of the
    step's CUDA graph) and returns its metrics as device tensors."""

    def __init__(self, cfg: dict, device=None):
        self.device = device = resolve_device(device)
        set_precision_flags()
        seed = cfg["seed"]
        dm_cfg, model_cfg = cfg["datamodule"], cfg["model"]
        sizes = camera_sizes(dm_cfg["transforms"])
        self.model = build_policy_for(cfg).to(device)
        opt_cfg = model_cfg["optimizer"]
        optimizer = make_optimizer(self.model.parameters(), opt_cfg)
        bf16 = self.model.compute_dtype == torch.bfloat16 and device.type == "cuda"
        transform = make_batch_transform(dm_cfg["observation_space"],
                                         dm_cfg["proprioception_dims"], dm_cfg["transforms"],
                                         dtype=torch.bfloat16 if bf16 else torch.float32)
        self.train_step = make_train_step(
            self.model, optimizer, transform, cfg["loss"]["clip_auxiliary_loss_beta"],
            aux_betas_from_loss_cfg(cfg["loss"]), device=device,
            scheduler=make_scheduler(optimizer, opt_cfg, model_cfg.get("lr_scheduler")),
            gradient_clip_norm=opt_cfg.get("gradient_clip_norm"))
        self.data = RandomWindowBatches(
            dm_cfg["batch_size_vis"], dm_cfg["batch_size_lang"], dm_cfg["max_window_size"],
            sizes["rgb_static"], sizes["rgb_gripper"], dm_cfg["action_space"],
            int(model_cfg.get("lang_task_classes", 34)), seed=seed, device=device,
            lang_dim=None if isinstance(self.model.lang_net, ClipTextTransformer)
            else model_cfg["language_goal"]["in_features"],
            depth_keys=dm_cfg["observation_space"]["depth_obs"],
            scene_obs="scene_obs" in dm_cfg["observation_space"]["state_obs"],
            tactile="rgb_tactile" in dm_cfg["observation_space"]["rgb_obs"])
        self.generator = torch.Generator(device=device).manual_seed(seed + 1)
        self.kl_beta = cfg["loss"]["kl_beta"]

    def next_batch(self) -> Dict:
        return self.data.next_batch()

    def step(self, raw: Dict, eager: bool = False) -> Dict[str, torch.Tensor]:
        return self.train_step(raw, self.generator, self.kl_beta, eager=eager)


def train(cfg: dict, max_steps: int, device, run_dir: str) -> TrainResult:
    """``max_steps`` train steps of the policy ``cfg`` on synthetic batches,
    logged to ``run_dir/metrics.jsonl``. A step's time runs from a
    synchronised start, its batch already made, to the host fetch of its
    metrics."""
    run = SyntheticRun(cfg, device)
    Path(run_dir).mkdir(parents=True, exist_ok=True)
    result = TrainResult(run.model)
    with open(Path(run_dir) / "metrics.jsonl", "a") as metrics_file:
        for i in range(max_steps):
            raw = run.next_batch()
            _synchronize(run.device)
            t0 = time.perf_counter()
            metrics = run.step(raw)
            names = sorted(metrics)
            values = torch.stack([metrics[k].float() for k in names]).tolist()
            step_ms = (time.perf_counter() - t0) * 1e3
            line = {"step": i, **dict(zip(names, values)), "step_ms": step_ms}
            result.history.append(line)
            metrics_file.write(json.dumps(line) + "\n")
            metrics_file.flush()
            print(f"step {i}: loss {line['loss']:.4f} total {line['total_loss']:.4f} "
                  f"grad_norm {line['grad_norm']:.3f} ({step_ms:.1f} ms)", flush=True)
    return result


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rollout_lang_embeddings(cfg: dict) -> Optional[Dict]:
    """The dataset's validation sentence -> embedding table for the rollout
    callbacks' language goals, or None without an ``embeddings.npy``."""
    from hulc2_torch.evaluation.evaluate_policy import load_lang_embeddings_file

    path = (Path(cfg["datamodule"]["root_data_dir"]) / "validation"
            / cfg["datamodule"].get("lang_folder", "lang_annotations") / "embeddings.npy")
    return load_lang_embeddings_file(path)[0] if path.is_file() else None


def fit(cfg: dict, run_dir, max_epochs: Optional[int] = None, max_steps: Optional[int] = None,
        device=None, shm_cache: bool = False) -> FitResult:
    """Train the policy ``cfg`` from the dataset at ``datamodule.root_data_dir``
    into ``run_dir`` with the callbacks it asks for, resuming from its newest
    checkpoint; one data-parallel rank of a started process group."""
    dm = Hulc2DataModule(cfg["datamodule"], seed=cfg.get("seed", 42), device=device,
                         use_shm_cache=shm_cache, process_index=process_index(),
                         process_count=process_count())
    try:
        dm.setup()
        callbacks = build_callbacks(cfg, run_dir, rollout_lang_embeddings(cfg))
        return Trainer(cfg, dm, run_dir, device=dm.device, callbacks=callbacks).fit(
            max_epochs, max_steps)
    finally:
        dm.close()


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic windows made on the device")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this many steps (required with --synthetic)")
    parser.add_argument("--max-epochs", type=int, default=None,
                        help="train up to this epoch (default: training.max_epochs)")
    parser.add_argument("--device", default=None,
                        help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    parser.add_argument("--run-dir", default=None,
                        help="run dir (default: runs/torch_synthetic or runs/torch_train)")
    parser.add_argument("--config-name", default=None, choices=options("root"),
                        help="a root of the config registry (default: the flagship preset)")
    parser.add_argument("--shm-cache", action="store_true",
                        help="read the training split from a shared-memory cache")
    parser.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = parser.parse_intermixed_args(argv)
    cfg = (flagship_config(args.overrides) if args.config_name is None
           else compose(args.config_name, args.overrides))
    device = args.device or (f"cuda:{local_rank()}" if launched_by_torchrun() else "cuda")
    if args.synthetic:
        if args.max_steps is None:
            parser.error("--synthetic needs --max-steps")
        if args.shm_cache:
            parser.error("--shm-cache reads a dataset: it does not go with --synthetic")
        return train(cfg, args.max_steps, device, args.run_dir or "runs/torch_synthetic")
    started = not torch.distributed.is_initialized() and initialize_distributed(device)
    try:
        return fit(cfg, args.run_dir or "runs/torch_train", args.max_epochs, args.max_steps,
                   device, args.shm_cache)
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main(sys.argv[1:])
