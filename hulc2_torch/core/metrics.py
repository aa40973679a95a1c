"""The run's metrics sinks and banners (``hulc2_tpu/core/metrics.py``).

``MetricsLogger`` appends one JSON line per ``log`` call to
``<run_dir>/metrics.jsonl`` (the step, the wall time and the metrics under
their prefix) and, when asked, fans the same scalars out to a tensorboard
``SummaryWriter`` under ``<run_dir>/tb`` and to wandb. Each optional sink is
imported when the logger is made; a sink whose package does not import is
skipped with a warning, as in JAX (``:73-79``). In a data-parallel run only
the main process writes. ``get_git_commit_hash`` and
``print_system_env_info`` are the banners the trainer logs at start; the
second names torch, CUDA, the device and the process's rank and world size in
place of JAX's backend fields.
"""
from __future__ import annotations

import json
import logging
import platform
import subprocess
import time
from pathlib import Path
from typing import Dict

logger = logging.getLogger(__name__)


def get_git_commit_hash(repo_path: Path) -> str:
    """The checkout's commit, with a warning when the tree has uncommitted
    changes; ``unknown`` outside a git checkout."""
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo_path, capture_output=True,
                             text=True, check=True).stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain"], cwd=repo_path,
                               capture_output=True, text=True).stdout.strip()
        if dirty:
            logger.warning("repository has uncommitted changes: the run may not be reproducible")
        return rev
    except Exception:  # noqa: BLE001 - no git, or not a checkout
        return "unknown"


def print_system_env_info(device=None) -> Dict[str, str]:
    """Logs and returns the Python, platform, torch and CUDA versions, the
    device's name, and this process's rank and world size."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device) if device is not None else None
    on_card = dev is not None and dev.type == "cuda"
    info = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "device": torch.cuda.get_device_name(dev) if on_card else str(dev or "cpu"),
        "rank": str(dist.get_rank() if dist.is_initialized() else 0),
        "world_size": str(dist.get_world_size() if dist.is_initialized() else 1),
    }
    for line in sorted(f"{k}: {v}" for k, v in info.items()):
        logger.info(line)
    return info


def _without_tensorflow() -> None:
    """Let tensorboard write its event files without importing TensorFlow.
    Where TensorFlow is installed, tensorboard imports all of it (more than
    10 s, and it may claim the card's memory) unless the marker module
    ``tensorboard.compat.notf`` exists, which the ``tensorboard-notf``
    distribution provides; then it uses its own file writer. The marker is
    registered unless TensorFlow is already imported."""
    import sys
    import types

    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))


class MetricsLogger:
    """metrics.jsonl, plus tensorboard (``use_tb``) and wandb (``use_wandb``)."""

    def __init__(self, run_dir, use_wandb: bool = False, use_tb: bool = False,
                 is_main: bool = True):
        self.run_dir = Path(run_dir)
        self.is_main = is_main
        self._fh = None
        self._wandb = None
        self._tb = None
        if not is_main:
            return
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.run_dir / "metrics.jsonl", "a", buffering=1)
        if use_wandb:
            try:
                import wandb

                wandb.init(project="hulc2_torch", dir=str(self.run_dir))
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001 - not installed, or offline
                logger.warning("wandb unavailable (%s); logging to metrics.jsonl only", e)
        if use_tb:
            try:
                _without_tensorflow()
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.run_dir / "tb"))
            except Exception as e:  # noqa: BLE001 - tensorboard not installed
                logger.warning("tensorboard unavailable (%s)", e)

    def log(self, metrics: Dict, step: int, prefix: str = "") -> dict:
        """The record of these metrics, written by the main process only."""
        flat = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        rec = {"step": int(step), "time": time.time(), **flat}
        if not self.is_main:
            return rec
        self._fh.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(flat, step=int(step))
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, int(step))
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
