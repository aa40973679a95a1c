"""Merge labelled affordance datasets into one (``hulc2_tpu/affordance/merge_datasets.py:30-88``).

    python -m hulc2_torch.affordance.merge_datasets OUT_DIR SRC_A SRC_B ... [--copy]

Each source is a directory that ``dataset_creation`` wrote
(``episodes_split.json`` and ``<episode>/data/<cam>_cam/*.npz``). The merge
links every source episode under ``<source dir name>_<episode>`` (copies it
with ``--copy``), takes the union of the training and validation splits,
and pools each camera's depth statistics over the sources, weighted by
their frame counts (the pooled variance: the mean variance plus the
variance of the means), so ``AffordanceDataset`` reads the merge as it
reads one mined dataset. Host only.
"""
from __future__ import annotations

import argparse
import json
import logging
import shutil
import sys
from pathlib import Path
from typing import Optional, Sequence

logger = logging.getLogger(__name__)


def merge_datasets(out_dir, src_dirs: Sequence, copy: bool = False) -> dict:
    """Write OUT_DIR's episodes and ``episodes_split.json``; returns the split."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    merged: dict = {"training": {}, "validation": {}}
    norm_acc: dict = {}  # cam -> [(n_frames, mean, std)] per source
    for src in map(Path, src_dirs):
        info = json.loads((src / "episodes_split.json").read_text())
        n_frames = sum(len(files) for split in ("training", "validation")
                       for content in info.get(split, {}).values() for files in content.values())
        for split in ("training", "validation"):
            for ep, content in info.get(split, {}).items():
                new_ep = f"{src.name}_{ep}"
                merged[split][new_ep] = content
                link = out_dir / new_ep
                if not link.exists():
                    if copy:
                        shutil.copytree(src / ep, link)
                    else:
                        link.symlink_to((src / ep).resolve())
        for cam, stats in info.get("norm_values", {}).get("depth", {}).items():
            norm_acc.setdefault(cam, []).append((n_frames, float(stats["mean"]),
                                                 float(stats["std"])))
    merged["norm_values"] = {"depth": {}}
    for cam, entries in norm_acc.items():
        total = sum(n for n, _, _ in entries) or 1
        mean = sum(n * m for n, m, _ in entries) / total
        var = sum(n * (s * s + (m - mean) ** 2) for n, m, s in entries) / total
        merged["norm_values"]["depth"][cam] = {"mean": mean, "std": var ** 0.5}
    (out_dir / "episodes_split.json").write_text(json.dumps(merged, indent=2))
    logger.info("merged %d sources -> %s (%d training episodes)", len(src_dirs), out_dir,
                len(merged["training"]))
    return merged


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out_dir")
    p.add_argument("src_dirs", nargs="+")
    p.add_argument("--copy", action="store_true", help="copy episode dirs instead of linking")
    args = p.parse_args(argv)
    return merge_datasets(args.out_dir, args.src_dirs, args.copy)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main(sys.argv[1:])
