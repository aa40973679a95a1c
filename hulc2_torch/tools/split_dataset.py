"""Split a play dataset into training and validation episodes, and compute
its statistics.

    python -m hulc2_torch.tools.split_dataset DATA_DIR [--val-percentage 0.1]
        [--max-val-episodes 5] [--strategy best|per_episode]

The port's copy of ``hulc2_tpu/tools/split_dataset.py`` (reference:
hulc2/utils/split_dataset.py:54-200): for a directory of per-frame npz files
with an ``ep_start_end_ids.npy`` it writes ``split.json`` (the training and
validation episode ranges) and ``statistics.yaml`` (robot_obs mean and std
and the action bounds over the training ranges), the same files as the JAX
package's. Strategies: ``best`` picks up to ``max_val_episodes`` whole
episodes whose length comes closest to the requested share; ``per_episode``
(and a single episode) cuts the tail of every episode.

Both packages' datamodules read a split's ``ep_start_end_ids.npy`` before
``split.json`` and need ``training/`` and ``validation/`` directories, so a
flat directory this tool wrote does not train as it stands, in either.
"""
from __future__ import annotations

import argparse
import itertools
import json
import logging
from pathlib import Path
from typing import Dict, List

import numpy as np

from hulc2_torch.data.frame_store import NpzFrameStore

logger = logging.getLogger(__name__)


def split_every_episode(ep_ids: np.ndarray, val_percentage: float) -> Dict[str, List]:
    lens = ep_ids[:, 1] - ep_ids[:, 0] + 1
    val_lens = (lens * val_percentage).astype(np.int64)
    split: Dict[str, List] = {"training": [], "validation": []}
    for (start, end), v in zip(ep_ids, val_lens):
        cut = int(end) - int(v)
        split["training"].append([int(start), cut - 1])
        split["validation"].append([cut, int(end)])
    return split


def find_best_split(ep_ids: np.ndarray, val_percentage: float, max_val_episodes: int = 5) -> Dict[str, List]:
    lens = ep_ids[:, 1] - ep_ids[:, 0] + 1
    if len(lens) == 1:
        return split_every_episode(ep_ids, val_percentage)
    ideal = int(lens.sum() * val_percentage)
    best, best_diff = None, float("inf")
    for k in range(1, max_val_episodes + 1):
        for comb in itertools.combinations(range(len(lens)), k):
            diff = abs(ideal - int(lens[list(comb)].sum()))
            if diff < best_diff:
                best, best_diff = comb, diff
                if diff == 0:
                    break
    val = set(best)
    return {
        "training": [[int(s), int(e)] for i, (s, e) in enumerate(ep_ids) if i not in val],
        "validation": [[int(s), int(e)] for i, (s, e) in enumerate(ep_ids) if i in val],
    }


def compute_statistics(data_dir: Path, training_ranges: List[List[int]]) -> Dict:
    """Mean and std of robot_obs and the min and max of the actions over the
    training ranges (reference: split_dataset.py:129-200), accumulated frame
    by frame."""
    store = NpzFrameStore(Path(data_dir), ["robot_obs", "actions", "rel_actions"])
    n = 0
    s = s2 = amin = amax = None
    for start, end in training_ranges:
        for idx in range(int(start), int(end) + 1):
            try:
                frame = store.load_frame(idx)
            except FileNotFoundError:
                continue
            ro = np.asarray(frame["robot_obs"], np.float64)
            if s is None:
                s, s2 = np.zeros_like(ro), np.zeros_like(ro)
            s += ro
            s2 += ro**2
            n += 1
            if "actions" in frame:
                a = np.asarray(frame["actions"], np.float64)
                amin = a if amin is None else np.minimum(amin, a)
                amax = a if amax is None else np.maximum(amax, a)
    mean = s / n
    std = np.sqrt(np.maximum(s2 / n - mean**2, 0.0))
    stats = {
        "robot_obs": [
            {
                "_target_": "calvin_agent.utils.transforms.NormalizeVector",
                "mean": [float(x) for x in mean],
                "std": [float(x) for x in std],
            }
        ],
    }
    if amin is not None:
        stats["act_min_bound"] = [float(x) for x in amin]
        stats["act_max_bound"] = [float(x) for x in amax]
    return stats


def write_yaml(stats: Dict, path: Path) -> None:
    import yaml

    Path(path).write_text(yaml.safe_dump(stats, sort_keys=False))


def split_dataset(data_dir, val_percentage: float = 0.1, max_val_episodes: int = 5,
                  strategy: str = "best") -> Dict:
    data_dir = Path(data_dir)
    ep_ids = np.load(data_dir / "ep_start_end_ids.npy")
    ep_ids = ep_ids[ep_ids[:, 0].argsort()]
    split = (
        find_best_split(ep_ids, val_percentage, max_val_episodes)
        if strategy == "best"
        else split_every_episode(ep_ids, val_percentage)
    )
    (data_dir / "split.json").write_text(json.dumps(split, indent=4))
    stats = compute_statistics(data_dir, split["training"])
    write_yaml(stats, data_dir / "statistics.yaml")
    logger.info("wrote split.json + statistics.yaml to %s", data_dir)
    return split


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("data_dir")
    p.add_argument("--val-percentage", type=float, default=0.1)
    p.add_argument("--max-val-episodes", type=int, default=5)
    p.add_argument("--strategy", choices=("best", "per_episode"), default="best")
    args = p.parse_args(argv)
    split_dataset(args.data_dir, args.val_percentage, args.max_val_episodes, args.strategy)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
