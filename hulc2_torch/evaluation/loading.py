"""Trained models from run dirs (``hulc2_tpu/evaluation/loading.py:96-155``).

A run's ``config.json`` is the model's spec; the newest (or a named) step
under ``saved_models/`` gives its parameters (``core/checkpoint.py``).
``load_policy`` reads a run of ``python -m hulc2_torch.training``,
``run_statistics`` the statistics it trained with (which its eval
normalises robot_obs with; JAX's fake-env eval hands its agent none),
``load_affordance`` a run of ``python -m hulc2_torch.affordance.train_affordance``,
``load_policy_from_torch_ckpt`` a reference PyTorch-Lightning ``.ckpt``.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

from hulc2_torch.core.checkpoint import CheckpointManager, load_run_config
from hulc2_torch.data.statistics import RUN_STATISTICS, DatasetStatistics, load_run_statistics
from hulc2_torch.models.build import build_policy_for
from hulc2_torch.models.hulc2 import Hulc2
from hulc2_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def load_policy(run_dir, step: Optional[int] = None) -> Tuple[Hulc2, dict, int]:
    """(model on the CPU, the run's config, the loaded step)."""
    run_dir = Path(run_dir)
    cfg = load_run_config(run_dir)
    model = build_policy_for(cfg)
    restored = CheckpointManager(run_dir).restore(step)
    if restored is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir}/saved_models")
    model.load_state_dict(restored["model"])
    logger.info("loaded step %d from %s", restored["step"], run_dir)
    return model, cfg, restored["step"]


def run_statistics(run_dir, cfg: dict) -> Optional[DatasetStatistics]:
    """The training split's statistics of a run, from the ``statistics.json``
    the trainer writes into every run dir. A run dir without it raises when
    the policy reads normalised state (a proprio encoder, or an observation
    space that names scene_obs); for any other policy it is None, which
    normalises nothing that policy reads."""
    stats = load_run_statistics(run_dir)
    if stats is None:
        proprio = (cfg["model"]["perceptual_encoder"].get("proprio") or {}).get("n_state_obs", 0)
        scene = "scene_obs" in cfg["datamodule"]["observation_space"].get("state_obs", ())
        if proprio or scene:
            raise FileNotFoundError(
                f"{Path(run_dir) / RUN_STATISTICS}: the training statistics this policy's "
                "robot_obs/scene_obs are normalised with")
    return stats


def load_affordance(run_dir, step: Optional[int] = None, device=None, seed: int = 0,
                    lang_table=None):
    """``AffordancePredictor`` on ``device`` (the card unless ``"cpu"`` is
    asked for) from an affordance run dir: the detector built from its
    config, the checkpoint's parameters and BatchNorm statistics, and the
    labels' ``depth_norm``."""
    from hulc2_torch.affordance.depth_heads import DepthNorm
    from hulc2_torch.affordance.detector import AffordancePredictor
    from hulc2_torch.affordance.train_affordance import build_detector, input_hw

    run_dir = Path(run_dir)
    cfg = load_run_config(run_dir)
    model = build_detector(cfg["aff_detection"])
    restored = CheckpointManager(run_dir).restore(step)
    if restored is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir}/saved_models")
    model.load_state_dict(restored["model"])
    logger.info("loaded affordance step %d from %s", restored["step"], run_dir)
    hw = input_hw(cfg["aff_detection"])
    return AffordancePredictor(model.to(resolve_device(device)), DepthNorm(**cfg["depth_norm"]),
                               (hw, hw), seed=seed, lang_table=lang_table)



def load_policy_from_torch_ckpt(ckpt_path, cfg: dict) -> Tuple[Hulc2, dict]:
    """(model on the CPU, the checkpoint's hyper-parameters) from a reference
    PyTorch-Lightning ``.ckpt`` (``hulc2_tpu/evaluation/loading.py:158``):
    the policy ``cfg`` builds, its weights the checkpoint's ``state_dict``.
    The port's names are the reference's (the language MLP's
    ``lang_encoder`` is the port's ``lang_net``), so the weights load
    without conversion; a key missing on either side raises."""
    from hulc2_torch.utils.convert import load_lightning_checkpoint

    sd, hparams = load_lightning_checkpoint(ckpt_path)
    renamed = {("lang_net." + k[len("lang_encoder."):] if k.startswith("lang_encoder.") else k): v
               for k, v in sd.items()}
    model = build_policy_for(cfg)
    model.load_state_dict(renamed, strict=True)
    return model, hparams
