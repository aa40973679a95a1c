"""Stitch saved real-world rollout image folders into montage videos.

    python -m hulc2_torch.tools.make_seq_videos INPUT_DIR [--fps 30]

The port's copy of ``hulc2_tpu/tools/make_seq_videos.py`` (reference:
hulc2/affordance/scripts/make_seq_videos.py:91-123): each sequence directory
holds per-task folders with the affordance prediction snapshot and, per
policy (model_based / model_free), the static and gripper cameras' PNG
streams, and a ``sequence*.txt`` caption file; each frame tiles [aff_pred /
gripper] left of the static view, captioned with the numbered instruction
(top) and the policy (bottom), and each sequence becomes one mp4 (a gif
where imageio has no ffmpeg). cv2 and imageio are imported when used.

Layout read::

    <input_dir>/<sequence_xxx>/
        sequence_tasks.txt              one caption per line, in task order
        <00_task_name>/
            aff_pred*.png               (optional; white placeholder if absent)
            <model_based|model_free>/
                static_cam/*.png
                gripper_cam/*.png
"""
from __future__ import annotations

import argparse
import logging
from glob import glob
from pathlib import Path
from typing import List, Optional

import numpy as np

from hulc2_torch.utils.img_utils import add_img_text

logger = logging.getLogger(__name__)

POLICY_TITLE = {"model_based": "Model-based policy", "model_free": "Learning-based policy"}


def _read_captions(seq_dir: Path) -> List[str]:
    files = sorted(seq_dir.glob("sequence*.txt"))
    if not files:
        return []
    return files[0].read_text().splitlines()


def merge_frame(aff_pred: np.ndarray, static_img: np.ndarray, gripper_img: np.ndarray,
                caption: str, policy_label: str, pad: int = 10) -> np.ndarray:
    """One montage frame: a column of [aff_pred / gripper] left of the static
    view (each half the static height), captioned top (instruction) and bottom
    (policy type) — reference merge_images layout (make_seq_videos.py:62-88)."""
    import cv2

    static = add_img_text(static_img, policy_label, bottom=True)
    h = static.shape[0]
    half = (h // 2 - pad, h // 2 - pad // 2)  # (w, h) for cv2.resize
    aff = cv2.resize(aff_pred, half)
    aff = np.pad(aff, ((0, pad // 2), (0, pad), (0, 0)), constant_values=255)
    grip = cv2.resize(gripper_img, half)
    grip = np.pad(grip, ((pad // 2, 0), (0, pad), (0, 0)), constant_values=255)
    left = np.vstack([aff, grip])
    if left.shape[0] != h:  # odd heights: trim/pad one row
        left = left[:h] if left.shape[0] > h else np.pad(
            left, ((0, h - left.shape[0]), (0, 0), (0, 0)), constant_values=255)
    full = np.hstack([left, static])
    return add_img_text(full, caption, bottom=False)


def _load_pngs(d: Path) -> List[np.ndarray]:
    import imageio.v2 as imageio

    return [np.asarray(imageio.imread(f))[..., :3] for f in sorted(d.glob("*.png"))]


def make_sequence_video(seq_dir: Path, fps: int = 30, out_path: Optional[Path] = None) -> Path:
    """Compose and write one sequence's mp4; returns the written path."""
    import imageio.v2 as imageio

    seq_dir = Path(seq_dir)
    task_dirs = sorted(p for p in seq_dir.iterdir() if p.is_dir())
    captions = _read_captions(seq_dir)[: len(task_dirs)]
    if len(captions) < len(task_dirs):  # pad with the folder name
        captions += [p.name for p in task_dirs[len(captions):]]

    frames: List[np.ndarray] = []
    for i, (caption, task_dir) in enumerate(zip(captions, task_dirs)):
        aff_files = sorted(glob(str(task_dir / "aff_pred*.png")))
        aff = (np.asarray(imageio.imread(aff_files[0]))[..., :3] if aff_files
               else np.full((100, 100, 3), 255, np.uint8))
        for policy_dir in sorted(p for p in task_dir.iterdir() if p.is_dir()):
            statics = _load_pngs(policy_dir / "static_cam")
            grippers = _load_pngs(policy_dir / "gripper_cam")
            label = POLICY_TITLE.get(policy_dir.name, policy_dir.name)
            instruction = f"{i + 1}. {caption}"
            for s, g in zip(statics, grippers):
                frames.append(merge_frame(aff, s, g, instruction, label))
    if not frames:
        raise FileNotFoundError(f"no rollout PNGs under {seq_dir}")
    out = out_path or seq_dir.with_suffix(".mp4")
    try:
        imageio.mimwrite(out, frames, fps=fps, macro_block_size=1)
    except Exception as e:  # no ffmpeg backend: gif fallback (as rollout_video)
        out = out.with_suffix(".gif")
        imageio.mimwrite(out, frames, duration=1.0 / fps)
        logger.warning("mp4 writer unavailable (%s) — wrote %s", e, out.name)
    logger.info("wrote %s (%d frames)", out, len(frames))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input_dir", help="directory of sequence_* rollout folders")
    p.add_argument("--fps", type=int, default=30)
    args = p.parse_args(argv)
    root = Path(args.input_dir).expanduser()
    seq_dirs = sorted(p for p in root.iterdir() if p.is_dir())
    for seq_dir in seq_dirs:
        try:
            make_sequence_video(seq_dir, args.fps)
        except FileNotFoundError as e:
            logger.warning("skipping %s: %s", seq_dir.name, e)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
