"""A trained policy from a training run dir (``hulc2_tpu/evaluation/loading.py:96-112``).

The run's ``config.json`` is the model's spec; the newest (or a named) step
under ``saved_models/`` gives its parameters (``core/checkpoint.py``).
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

from hulc2_torch.core.checkpoint import CheckpointManager, load_run_config
from hulc2_torch.data.device_transforms import camera_sizes
from hulc2_torch.models.build import build_policy
from hulc2_torch.models.hulc2 import Hulc2

logger = logging.getLogger(__name__)


def load_policy(run_dir, step: Optional[int] = None) -> Tuple[Hulc2, dict, int]:
    """(model on the CPU, the run's config, the loaded step)."""
    run_dir = Path(run_dir)
    cfg = load_run_config(run_dir)
    sizes = camera_sizes(cfg["datamodule"]["transforms"])
    model = build_policy(cfg["model"], gripper_hw=sizes["rgb_gripper"])
    restored = CheckpointManager(run_dir).restore(step)
    if restored is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir}/saved_models")
    model.load_state_dict(restored["model"])
    logger.info("loaded step %d from %s", restored["step"], run_dir)
    return model, cfg, restored["step"]
