"""Dataset statistics (``statistics.yaml``) parsing (``hulc2_tpu/data/statistics.py``).

The port's numpy-only copy. It extracts the robot_obs / scene_obs
normalization vectors and the action bounds. Without PyYAML the fallback
parser reads the file's restricted layout; unlike the JAX package's fallback,
it also joins a flow list that continues over several lines (as the mean and
std of the generated datasets' ``statistics.yaml`` do), so both parsers give
the same statistics. ``save_statistics`` / ``load_run_statistics`` keep the
training split's statistics in a run dir (``statistics.json``), for the
run's evaluation.
"""
from __future__ import annotations

import json
import logging
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class DatasetStatistics:
    robot_obs_mean: Optional[np.ndarray] = None
    robot_obs_std: Optional[np.ndarray] = None
    scene_obs_mean: Optional[np.ndarray] = None
    scene_obs_std: Optional[np.ndarray] = None
    act_min_bound: Optional[List[float]] = None
    act_max_bound: Optional[List[float]] = None


def load_statistics(dataset_dir: Path) -> DatasetStatistics:
    """Parse statistics.yaml (NormalizeVector mean/std + action bounds)."""
    path = Path(dataset_dir) / "statistics.yaml"
    stats = DatasetStatistics()
    if not path.is_file():
        logger.warning("no statistics.yaml in %s — using identity normalization", dataset_dir)
        return stats
    try:
        import yaml

        raw = yaml.safe_load(path.read_text())
    except ImportError:  # fallback parser for the known layout
        raw = parse_simple_yaml(path.read_text())

    for key, mean_attr, std_attr in (
        ("robot_obs", "robot_obs_mean", "robot_obs_std"),
        ("scene_obs", "scene_obs_mean", "scene_obs_std"),
    ):
        for e in raw.get(key) or []:
            if isinstance(e, dict) and "mean" in e and "std" in e:
                setattr(stats, mean_attr, np.asarray(e["mean"], np.float32))
                setattr(stats, std_attr, np.asarray(e["std"], np.float32))
    if "act_min_bound" in raw:
        stats.act_min_bound = [float(v) for v in raw["act_min_bound"]]
    if "act_max_bound" in raw:
        stats.act_max_bound = [float(v) for v in raw["act_max_bound"]]
    return stats


def _logical_lines(text: str):
    """The file's lines with a flow list that spans several lines joined
    into the line that opens it."""
    pending = ""
    for line in text.splitlines():
        if pending:
            pending += " " + line.strip()
        elif line.strip() and not line.strip().startswith("#"):
            pending = line
        else:
            continue
        if pending.count("[") <= pending.count("]"):
            yield pending
            pending = ""
    if pending:
        yield pending


def parse_simple_yaml(text: str) -> dict:
    """Fallback for statistics.yaml's restricted structure: top-level keys
    holding a list of ``- _target_:`` entries with flow-list fields, or a flow
    list themselves."""
    out: dict = {}
    current_key = None
    current_entry = None
    for line in _logical_lines(text):
        m = re.match(r"^(\w+):\s*$", line)
        if m:
            current_key = m.group(1)
            out[current_key] = []
            continue
        m = re.match(r"^(\w+):\s*(\[.*\])\s*$", line)
        if m:
            out[m.group(1)] = json.loads(m.group(2))
            continue
        if re.match(r"^\s*-\s*_target_:", line) and current_key:
            current_entry = {}
            out[current_key].append(current_entry)
            continue
        m = re.match(r"^\s*(\w+):\s*(\[.*\])\s*$", line)
        if m and current_entry is not None:
            current_entry[m.group(1)] = json.loads(m.group(2))
    return out


RUN_STATISTICS = "statistics.json"


def save_statistics(run_dir: Path, stats: DatasetStatistics) -> None:
    """Write ``stats`` into a run dir as ``statistics.json`` (the fields that
    are set), for the run's evaluation."""
    fields = {k: np.asarray(v, np.float32).tolist() for k, v in vars(stats).items()
              if v is not None}
    (Path(run_dir) / RUN_STATISTICS).write_text(json.dumps(fields, indent=1))


def load_run_statistics(run_dir: Path) -> Optional[DatasetStatistics]:
    """The statistics a run trained with (``save_statistics``), or None for a
    run dir without them."""
    path = Path(run_dir) / RUN_STATISTICS
    if not path.is_file():
        return None
    fields = json.loads(path.read_text())
    stats = DatasetStatistics()
    for k, v in fields.items():
        setattr(stats, k, np.asarray(v, np.float32) if k.endswith(("_mean", "_std")) else list(v))
    return stats
