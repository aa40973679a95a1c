"""Checkpoints and the run's config (``hulc2_tpu/core/checkpoint.py``).

A run dir holds ``config.json`` (the composed config, the model's spec) and
``saved_models/<step>.pt``, one file per saved step with the model's
parameters, the optimizer's and the learning-rate scheduler's state, the
step and the metrics it was saved with. A file is written under a temporary
name and renamed into place, so a reader never sees a partial checkpoint.

Retention (``callbacks/checkpoint``): ``save_top_k=-1`` keeps every step.
With k > 0 and no ``monitor`` the newest k stay; with a ``monitor`` the best
k by that metric and ``mode`` (``min`` or ``max``), the newer of two equal
ones first, and a step saved without it (an epoch whose rollouts did not
run) last. The monitor is matched against the names the run logs
(``val/<key>``, the callbacks' ``eval_lh/...``, ``tasks/...``): one that
names neither a saved metric nor one of ``known_names`` (the callbacks'
keys of a later epoch) raises at the first save and lists them.
A save without metrics (after a preemption signal, which skips validation)
is kept until the next save, since a resumed run starts from it.
JAX's manager never receives the monitor (``hulc2_tpu/train/trainer.py:119``)
and reads a missing one as 0 (``core/checkpoint.py:31``), so it keeps the
newest k. A resumed run continues from the newest kept step. The JAX
package's orbax checkpoints are not readable here.
"""
from __future__ import annotations

import json
import logging
import math
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

logger = logging.getLogger(__name__)


class CheckpointManager:
    def __init__(self, run_dir, save_top_k: int = -1, monitor: Optional[str] = None,
                 mode: str = "min", known_names: Sequence[str] = ()):
        if mode not in ("min", "max"):
            raise ValueError(f"checkpoint mode {mode!r}: min or max")
        self.ckpt_dir = Path(run_dir) / "saved_models"
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.mode = mode
        self.known_names = set(known_names)
        self._metrics: Dict[int, Dict[str, float]] = {}  # step -> its saved metrics

    def _path(self, step: int) -> Path:
        return self.ckpt_dir / f"{step}.pt"

    def all_steps(self) -> List[int]:
        if not self.ckpt_dir.is_dir():
            return []
        return sorted(int(p.stem) for p in self.ckpt_dir.glob("*.pt") if p.stem.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def saved_metrics(self, step: int) -> Dict[str, float]:
        """The metrics ``step`` was saved with (read once, memory-mapped)."""
        if step not in self._metrics:
            ck = torch.load(self._path(step), map_location="cpu", weights_only=True, mmap=True)
            self._metrics[step] = ck.get("metrics") or {}
        return self._metrics[step]

    def _score(self, metrics: Dict[str, float]) -> float:
        value = metrics.get(self.monitor, math.nan)
        if math.isnan(value):  # ranked last
            return -math.inf
        return value if self.mode == "max" else -value

    def save(self, step: int, model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer],
             metrics: Optional[Dict[str, float]] = None, scheduler=None) -> Path:
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        if (self.monitor is not None and self.save_top_k != -1 and metrics
                and self.monitor not in metrics and self.monitor not in self.known_names):
            raise ValueError(f"checkpoint monitor {self.monitor!r} names no metric of this run; "
                             f"its metrics are {sorted(set(metrics) | self.known_names)}")
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        path = self._path(step)
        tmp = path.with_name(f".{path.name}.tmp")
        torch.save({"step": int(step), "model": model.state_dict(),
                    "optimizer": None if optimizer is None else optimizer.state_dict(),
                    "scheduler": None if scheduler is None else scheduler.state_dict(),
                    "metrics": metrics}, tmp)
        os.replace(tmp, path)
        self._metrics[int(step)] = metrics
        if self.save_top_k > 0:
            steps = self.all_steps()
            if self.monitor is None:
                keep = set(steps[-self.save_top_k:])
            else:
                ranked = sorted(steps, key=lambda s: (self._score(self.saved_metrics(s)), s),
                                reverse=True)
                keep = set(ranked[:self.save_top_k])
                if not metrics:  # a preemption's save: the resume point
                    keep.add(int(step))
            for old in steps:
                if old not in keep:
                    self._path(old).unlink()
                    self._metrics.pop(old, None)
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
