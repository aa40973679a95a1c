"""Tiny versions of the cells for the CPU tests: the same runners and
reference at small widths, batches and datasets."""
from __future__ import annotations

import copy
import time
from pathlib import Path

from portbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {
    "plan_proposal": {"hidden_size": 32},
    "plan_recognition": {"encoder_hidden_size": 32, "fc_hidden_size": 32,
                         "max_position_embeddings": 8},
    "visual_goal": {"hidden_size": 32},
    "language_goal": {"hidden_size": 32},
    "action_decoder": {"hidden_size": 32},
}
TINY_DM = {"batch_size_vis": 2, "batch_size_lang": 2, "min_window_size": 4,
           "max_window_size": 8, "num_workers": 2}


def _merge(base: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v


def tiny_cell(name: str, bench: dict = None) -> dict:
    bench = bench or spec.load_benchmark(ROOT)
    cell = copy.deepcopy(spec.load_cell(bench, name))
    cfg = cell["config"]["config"]
    _merge(cfg["model"], TINY_MODEL)
    _merge(cfg["datamodule"], TINY_DM)
    if cfg["model"].get("language_encoder"):
        _merge(cfg["model"]["language_encoder"], {"width": 32, "heads": 2, "layers": 1})
    cell["traffic"].update(splits={"training": [2, 40], "validation": [1, 20]}, store_rows=200,
                           warmup_steps=1, profile_steps=2)
    return cell


def context(cell: dict, tmp: Path, seed: int = 5, fault=None):
    """A half-second run of ``cell`` on the CPU, untraced."""
    import torch

    from portbench.run import Context

    return Context(cell["entry"]["name"], cell["config"], cell["traffic"], seed, 0.5, False,
                   torch.device("cpu"), Path(tmp), time.perf_counter(), fault=fault)
