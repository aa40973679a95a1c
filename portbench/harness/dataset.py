"""A seeded synthetic dataset in CALVIN's on-disk layout, written by the
benchmark for both sides: the program reads it through its datamodule, the
reference (``reference/data.py``) reads the same files.

Per split, ``episode_XXXXXXX.npz`` per frame (``rgb_static`` and
``rgb_gripper`` uint8 noise, ``robot_obs`` 15, ``scene_obs`` 24,
``rel_actions`` and ``actions`` 7, float32), ``ep_start_end_ids.npy``,
``lang_annotations/auto_lang_ann.npy`` (sentences, task names, 384-d
embeddings, frame ranges), ``lang_annotations/embeddings.npy`` and
``statistics.yaml`` with CALVIN's published statistics and action bounds.
The layout and the default counts are those of the port's
``tools/make_synthetic_dataset.py`` (2 x 400 + 150 frames); the scene does not
evolve through real task transitions, which no training cell needs, and each
split gets as many annotations as its episodes hold windows. Everything is
drawn from ``numpy.random.default_rng(seed)`` in a few bulk calls.

``tile_index`` writes the episode and annotation index of a split of many
more frames whose frames are copies of a written split's: copy ``c`` of
frame ``i`` has the id ``i + c * period``, the copies' episodes and
annotated ranges follow one another, and the last copy stops at the rows
asked for. A sampler over that index draws its windows across all the rows,
and an epoch lasts as long as one of a split of that size.
"""
from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from portbench.reference.port.evaluation.tasks import TASK_NAMES

STATS_YAML = """robot_obs:
  - _target_: calvin_agent.utils.transforms.NormalizeVector
    mean: [0.027, -0.21, 0.54, 1.64, -0.02, 1.62, 0.06, -0.44, 0.64, 0.36,
           -1.86, -0.35, 1.58, 0.93, -0.07]
    std: [0.11, 0.13, 0.062, 2.8, 0.04, 0.52, 0.042, 0.27, 0.345, 0.24,
          0.51, 0.42, 0.9, 0.57, 1.0]
act_min_bound: [-0.432188, -0.545456, -0.49, -1.570796, -0.57, -1.570796, -1.0]
act_max_bound: [0.432188, 0.269608, 0.63, 1.570796, 0.52, 1.570796, 1.0]
"""
ROBOT_MEAN = np.array([0.027, -0.21, 0.54, 1.64, -0.02, 1.62, 0.06, -0.44, 0.64, 0.36,
                       -1.86, -0.35, 1.58, 0.93, -0.07], np.float32)
ROBOT_STD = np.array([0.11, 0.13, 0.062, 2.8, 0.04, 0.52, 0.042, 0.27, 0.345, 0.24,
                      0.51, 0.42, 0.9, 0.57, 1.0], np.float32)
ANN_SPAN = 64  # frames of one annotated range, as the port's generator makes them
LANG_DIM = 384


def _save_frame(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    """One frame as ``np.savez`` writes it (a stored zip of .npy members)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for key, a in arrays.items():
            with z.open(f"{key}.npy", "w", force_zip64=False) as f:
                np.lib.format.write_array(f, np.ascontiguousarray(a), allow_pickle=False)


def episode_ranges(n_eps: int, n_frames: int) -> np.ndarray:
    """Episode e spans frames [e (n + 100), e (n + 100) + n - 1], as in the
    port's generator."""
    return np.asarray([(e * (n_frames + 100), e * (n_frames + 100) + n_frames - 1)
                       for e in range(n_eps)], np.int64)


def write_dataset(root, seed: int, static_hw: int, gripper_hw: int, splits: Dict[str, Tuple[int, int]],
                  min_window: int = 20) -> Path:
    """Write ``splits`` ({split: (episodes, frames per episode)}) under
    ``root``; returns ``root``."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, (n_eps, n_frames) in splits.items():
        d = root / split
        (d / "lang_annotations").mkdir(parents=True, exist_ok=True)
        ranges = episode_ranges(n_eps, n_frames)
        np.save(d / "ep_start_end_ids.npy", ranges)
        n = n_eps * n_frames
        static = rng.integers(0, 256, (n, static_hw, static_hw, 3), np.uint8)
        gripper = rng.integers(0, 256, (n, gripper_hw, gripper_hw, 3), np.uint8)
        robot = (ROBOT_MEAN + ROBOT_STD * rng.standard_normal((n, 15))).astype(np.float32)
        robot[:, 14] = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        scene = (0.1 * rng.standard_normal((n, 24))).astype(np.float32)
        rel = np.clip(0.2 * rng.standard_normal((n, 7)), -1, 1).astype(np.float32)
        rel[:, 6] = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        absolute = np.clip(rng.standard_normal((n, 7)), -1, 1).astype(np.float32)
        ids = np.concatenate([np.arange(s, e + 1) for s, e in ranges])
        for j, i in enumerate(ids):
            _save_frame(d / f"episode_{i:07d}.npz", {
                "rgb_static": static[j], "rgb_gripper": gripper[j], "robot_obs": robot[j],
                "scene_obs": scene[j], "rel_actions": rel[j], "actions": absolute[j]})
        # annotated ranges of ANN_SPAN frames: as many as give the language
        # index about as many windows as the vision index
        span = min(ANN_SPAN, n_frames)
        n_ann = max(1, -(-n_eps * (n_frames - min_window + 1) // max(1, span - min_window)))
        ep = rng.integers(0, n_eps, n_ann)
        lo = ranges[ep, 0] + rng.integers(0, n_frames - span + 1, n_ann)
        tasks = [TASK_NAMES[int(t)] for t in rng.integers(0, len(TASK_NAMES), n_ann)]
        anns = [f"{t.replace('_', ' ')} now" if k % 2 else t.replace("_", " ")
                for k, t in enumerate(tasks)]
        emb = rng.standard_normal((n_ann, 1, LANG_DIM)).astype(np.float32)
        ann = {"language": {"ann": anns, "task": tasks, "emb": emb},
               "info": {"episodes": [], "indx": [(int(a), int(a) + span - 1) for a in lo]}}
        np.save(d / "lang_annotations" / "auto_lang_ann.npy", ann, allow_pickle=True)
        lookup = {t: {"ann": [t.replace("_", " ")],
                      "emb": rng.standard_normal((1, LANG_DIM)).astype(np.float32)}
                  for t in TASK_NAMES}
        np.save(d / "lang_annotations" / "embeddings.npy", lookup, allow_pickle=True)
        (d / "statistics.yaml").write_text(STATS_YAML)
    return root


def tile_index(split_dir, out_dir, rows: int, min_episode: int) -> dict:
    """Write ``ep_start_end_ids.npy``, ``lang_annotations/auto_lang_ann.npy``
    and ``tiling.json`` under ``out_dir`` for ``rows`` frames tiled from the
    split at ``split_dir`` (its episodes in order, copy after copy; the last
    episode cut to the rows left, which must be at least ``min_episode``
    frames); returns the tiling: {"rows", "period", "copies", "base_rows"}."""
    split_dir, out_dir = Path(split_dir), Path(out_dir)
    ranges = np.load(split_dir / "ep_start_end_ids.npy")
    lens = ranges[:, 1] - ranges[:, 0] + 1
    base = int(lens.sum())
    period = int(ranges[:, 1].max()) + 1 + 100  # a gap between copies, as between episodes
    tiled, left, c = [], rows, 0
    while left > 0:
        for (s, e), n in zip(ranges, lens):
            take = min(int(n), left)
            if take == 0:
                break
            if take < min_episode:
                raise ValueError(f"{rows} rows leave a last episode of {take} frames")
            tiled.append((int(s) + c * period, int(s) + take - 1 + c * period))
            left -= take
        c += 1
    tiled = np.asarray(tiled, np.int64)
    ann = np.load(split_dir / "lang_annotations" / "auto_lang_ann.npy", allow_pickle=True).item()
    indx = np.asarray(ann["info"]["indx"], np.int64)
    keep, where = [], []
    for copy in range(c):
        lo, hi = tiled[:, 0] - copy * period, tiled[:, 1] - copy * period
        mine = (tiled[:, 0] >= copy * period) & (tiled[:, 0] < (copy + 1) * period)
        for a, (s, e) in enumerate(indx):
            if np.any(mine & (lo <= s) & (e <= hi)):
                keep.append(a)
                where.append(copy * period)
    keep, shift = np.asarray(keep, np.int64), np.asarray(where, np.int64)
    out = {"language": {"ann": [ann["language"]["ann"][a] for a in keep],
                        "task": [ann["language"]["task"][a] for a in keep],
                        "emb": np.asarray(ann["language"]["emb"])[keep]},
           "info": {"episodes": [], "indx": [(int(s), int(e)) for s, e in indx[keep] + shift[:, None]]}}
    (out_dir / "lang_annotations").mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "ep_start_end_ids.npy", tiled)
    np.save(out_dir / "lang_annotations" / "auto_lang_ann.npy", out, allow_pickle=True)
    tiling = {"rows": rows, "period": period, "copies": c, "base_rows": base}
    (out_dir / "tiling.json").write_text(json.dumps(tiling))
    return tiling
