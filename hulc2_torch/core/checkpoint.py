"""Checkpoints and the run's config (``hulc2_tpu/core/checkpoint.py``).

A run dir holds ``config.json`` (the composed config, the model's spec) and
``saved_models/<step>.pt``, one file per saved step with the model's
parameters, the optimizer's and the learning-rate scheduler's state and the
step. A file is written under a
temporary name and renamed into place, so a reader never sees a partial
checkpoint. ``save_top_k=-1`` keeps every step; k > 0 keeps the newest k.
The JAX package's orbax checkpoints are not readable here.
"""
from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)


class CheckpointManager:
    def __init__(self, run_dir, save_top_k: int = -1):
        self.ckpt_dir = Path(run_dir) / "saved_models"
        self.save_top_k = save_top_k

    def _path(self, step: int) -> Path:
        return self.ckpt_dir / f"{step}.pt"

    def all_steps(self) -> List[int]:
        if not self.ckpt_dir.is_dir():
            return []
        return sorted(int(p.stem) for p in self.ckpt_dir.glob("*.pt") if p.stem.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
             metrics: Optional[Dict[str, float]] = None, scheduler=None) -> Path:
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        path = self._path(step)
        tmp = path.with_name(f".{path.name}.tmp")
        torch.save({"step": int(step), "model": model.state_dict(),
                    "optimizer": None if optimizer is None else optimizer.state_dict(),
                    "scheduler": None if scheduler is None else scheduler.state_dict(),
                    "metrics": {k: float(v) for k, v in (metrics or {}).items()}}, tmp)
        os.replace(tmp, path)
        if self.save_top_k > 0:
            for old in self.all_steps()[:-self.save_top_k]:
                self._path(old).unlink()
        logger.info("saved step %d to %s", step, path)
        return path

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The checkpoint of ``step`` (default: the newest) on the CPU, or
        None when the run has none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self._path(step)
        if not path.is_file():
            raise FileNotFoundError(f"no checkpoint of step {step} under {self.ckpt_dir}")
        return torch.load(path, map_location="cpu", weights_only=True)


def save_run_config(run_dir, cfg: dict) -> None:
    p = Path(run_dir)
    p.mkdir(parents=True, exist_ok=True)
    (p / "config.json").write_text(json.dumps(cfg, indent=2, default=str))


def load_run_config(run_dir) -> dict:
    return json.loads((Path(run_dir) / "config.json").read_text())
