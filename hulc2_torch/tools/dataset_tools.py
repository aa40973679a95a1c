"""Small dataset utilities: merging, proprioception statistics, percentage
subsets, the episodes_split format conversion and the raw real-data split.

    python -m hulc2_torch.tools.dataset_tools combine SRC... --out-dir OUT
    python -m hulc2_torch.tools.dataset_tools proprio-stats DATA_DIR
    python -m hulc2_torch.tools.dataset_tools split-percentages ROOT [--percents 0.75 0.5 0.25]
    python -m hulc2_torch.tools.dataset_tools transform-episodes-split ROOT
    python -m hulc2_torch.tools.dataset_tools split-raw-real ROOT [--last-k K] [--seed S]

The port's copy of ``hulc2_tpu/tools/dataset_tools.py``, numpy only; with
the same inputs it writes the same files (reference roles:
hulc2/utils/combine_dataset.py:49,
hulc2/utils/compute_proprioception_statistics.py:14,
hulc2/affordance/dataset_creation/create_percentage_data_splits.py:8,
hulc2/affordance/scripts/transform_old_episodes_split.py:12,
hulc2/utils/convert_real_raw_data_splits.py:22).
"""
from __future__ import annotations

import argparse
import json
import logging
import shutil
from pathlib import Path
from typing import List, Optional

import numpy as np

from hulc2_torch.data.frame_store import NpzFrameStore

logger = logging.getLogger(__name__)


def combine_datasets(src_dirs: List, out_dir) -> np.ndarray:
    """Concatenate several frame datasets, renumbering frames and episode
    ranges (reference: combine_dataset.py:49)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    offset = 0
    all_ranges = []
    for src in src_dirs:
        src = Path(src)
        store = NpzFrameStore(src, [])
        ep_ids = np.load(src / "ep_start_end_ids.npy")
        for start, end in ep_ids:
            for i in range(int(start), int(end) + 1):
                shutil.copyfile(
                    store.frame_path(i),
                    out_dir / f"episode_{offset + i - int(start):07d}.npz",
                )
            all_ranges.append([offset, offset + int(end) - int(start)])
            offset += int(end) - int(start) + 1
    ranges = np.asarray(all_ranges)
    np.save(out_dir / "ep_start_end_ids.npy", ranges)
    logger.info("combined %d datasets -> %s (%d frames)", len(src_dirs), out_dir, offset)
    return ranges


def compute_proprioception_statistics(data_dir) -> dict:
    """Streaming mean/std/min/max of robot_obs over all frames
    (reference: compute_proprioception_statistics.py:14)."""
    data_dir = Path(data_dir)
    store = NpzFrameStore(data_dir, ["robot_obs"])
    ep_ids = np.load(data_dir / "ep_start_end_ids.npy")
    n, s, s2, mn, mx = 0, None, None, None, None
    for start, end in ep_ids:
        for i in range(int(start), int(end) + 1):
            ro = np.asarray(store.load_frame(i)["robot_obs"], np.float64)
            if s is None:
                s, s2 = np.zeros_like(ro), np.zeros_like(ro)
                mn, mx = ro.copy(), ro.copy()
            s += ro
            s2 += ro**2
            mn, mx = np.minimum(mn, ro), np.maximum(mx, ro)
            n += 1
    mean = s / n
    std = np.sqrt(np.maximum(s2 / n - mean**2, 0))
    stats = {
        "mean": mean.tolist(), "std": std.tolist(),
        "min": mn.tolist(), "max": mx.tolist(), "n_frames": n,
    }
    (data_dir / "proprioception_statistics.json").write_text(json.dumps(stats, indent=1))
    return stats


def split_episodes_by_percentage(root_dir, episodes_split: dict, data_percent: float) -> dict:
    """Restrict the *training* half of an affordance ``episodes_split`` to the
    first ``data_percent`` of play frames (reference:
    hulc2/affordance/utils/data_utils.py split_by_percentage:9-34 — frames are
    kept iff their trailing numeric id falls inside the truncated
    ``ep_start_end_ids`` ranges, so percentage subsets line up with the policy
    datamodule's own ``apply_data_percent`` slicing)."""
    from copy import deepcopy

    from hulc2_torch.data.episode_index import apply_data_percent

    root_dir = Path(root_dir)
    orig_ids = np.load(root_dir / "training" / "ep_start_end_ids.npy")
    new_ids = apply_data_percent(orig_ids, data_percent)
    out = deepcopy(episodes_split)
    for ep, cams in episodes_split["training"].items():
        if not isinstance(cams, dict):
            continue
        for cam, frames in cams.items():
            ids = np.array([int(f.split("_")[-1]) for f in frames], dtype=np.int64)
            keep = np.zeros(len(ids), dtype=bool)
            for start, end in new_ids:
                keep |= (ids >= start) & (ids <= end)
            out["training"][ep][cam] = [f for f, k in zip(frames, keep) if k]
    return out


def create_percentage_splits(root_dir, percents=(0.75, 0.5, 0.25)) -> List[Path]:
    """Write ``episodes_split_<pct>.json`` subset files (reference:
    hulc2/affordance/dataset_creation/create_percentage_data_splits.py:8-20)."""
    root_dir = Path(root_dir)
    episodes_split = json.loads((root_dir / "episodes_split.json").read_text())
    written = []
    for pct in percents:
        subset = split_episodes_by_percentage(root_dir, episodes_split, pct)
        f = root_dir / f"episodes_split_{pct * 100}.json"
        f.write_text(json.dumps(subset, indent=2))
        logger.info("wrote %s", f)
        written.append(f)
    return written


def transform_old_episodes_split(root_dir) -> Path:
    """Convert a flat old-format episodes_split ({ep: ["static_cam/frame_x",
    ...]}) to the nested per-camera layout (reference:
    hulc2/affordance/scripts/transform_old_episodes_split.py:12-26)."""
    root_dir = Path(root_dir)
    old = json.loads((root_dir / "episodes_split.json").read_text())
    new = {"training": {}, "validation": {}}
    for split in ("training", "validation"):
        for ep, frames in old.get(split, {}).items():
            new[split][ep] = {"gripper_cam": [], "static_cam": []}
            for frame in frames:
                cam_type, frame_name = frame.split("/")
                new[split][ep][cam_type].append(frame_name)
    out = root_dir / "episodes_split_new.json"
    out.write_text(json.dumps(new, indent=2))
    logger.info("wrote %s", out)
    return out


def split_raw_real_dataset(dataset_root, last_k: int = 0, seed: Optional[int] = None) -> dict:
    """Partition a flat raw real-robot recording (frame npz files +
    ``ep_start_end_ids.npy``) into training/ and validation/ subdirectories
    (reference: hulc2/utils/convert_real_raw_data_splits.py:22-86).

    last_k > 0 reserves the final K episodes for validation; last_k == 0 draws
    a random ~10% of episodes instead. Frames are *moved* (renamed), matching
    the reference.
    """
    import math
    import re

    root = Path(dataset_root)
    ep_ids = np.load(root / "ep_start_end_ids.npy")
    n_episodes = ep_ids.shape[0]
    files = sorted(
        x for x in root.glob("*.npz") if x.is_file() and "camera_info.npz" not in x.name
    )
    stem0 = files[0].stem
    prefix = re.split(r"\d+", stem0)[0]
    n_digits = len(re.findall(r"\d+", stem0)[0])

    if last_k > 0:
        if last_k >= n_episodes:
            raise ValueError(f"last_k={last_k} >= n_episodes={n_episodes}")
        val_rows = np.arange(n_episodes)[-last_k:]
    else:
        rng = np.random.default_rng(seed)
        val_size = math.ceil(n_episodes * 0.1)
        val_rows = rng.permutation(n_episodes)[:val_size]
    train_rows = np.array([i for i in range(n_episodes) if i not in set(val_rows.tolist())])
    val_ids, train_ids = ep_ids[val_rows], ep_ids[train_rows]

    (root / "training").mkdir(exist_ok=True)
    (root / "validation").mkdir(exist_ok=True)
    np.save(root / "validation" / "ep_start_end_ids.npy", val_ids)
    np.save(root / "training" / "ep_start_end_ids.npy", train_ids)
    np.save(root / "all_ep_start_end_ids.npy", ep_ids)
    by_id = {int(re.findall(r"\d+", f.stem)[0]): f for f in files}
    for split, rows in (("validation", val_ids), ("training", train_ids)):
        for start, end in rows:
            for fid in range(int(start), int(end) + 1):
                name = f"{prefix}{fid:0{n_digits}d}.npz"
                by_id[fid].rename(root / split / name)
    logger.info("split %d episodes -> %d train / %d val", n_episodes, len(train_ids), len(val_ids))
    return {"training": train_ids, "validation": val_ids}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("combine")
    c.add_argument("src_dirs", nargs="+")
    c.add_argument("--out-dir", required=True)
    s = sub.add_parser("proprio-stats")
    s.add_argument("data_dir")
    pc = sub.add_parser("split-percentages", help="episodes_split_<pct>.json subsets")
    pc.add_argument("root_dir")
    pc.add_argument("--percents", type=float, nargs="+", default=[0.75, 0.5, 0.25])
    tr = sub.add_parser("transform-episodes-split", help="old flat format -> per-camera")
    tr.add_argument("root_dir")
    rr = sub.add_parser("split-raw-real", help="flat raw recording -> training/validation dirs")
    rr.add_argument("dataset_root")
    rr.add_argument("--last-k", type=int, default=0,
                    help="reserve final K episodes for validation (0 = random 10%%)")
    rr.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    if args.cmd == "combine":
        combine_datasets(args.src_dirs, args.out_dir)
    elif args.cmd == "proprio-stats":
        compute_proprioception_statistics(args.data_dir)
    elif args.cmd == "split-percentages":
        create_percentage_splits(args.root_dir, args.percents)
    elif args.cmd == "transform-episodes-split":
        transform_old_episodes_split(args.root_dir)
    else:
        split_raw_real_dataset(args.dataset_root, args.last_k, args.seed)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
