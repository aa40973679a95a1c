"""Annotated rollout videos (``hulc2_tpu/train/rollout_video.py``), on the host.

``RolloutVideo`` collects a rollout's static frames, draws a green (success)
or red (failure) border and the instruction's caption, can paste a goal
thumbnail in the top right corner, and writes each finished video as mp4
through imageio, or as a gif where no mp4 writer is available. cv2 and
imageio are imported by the functions that need them.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List

import numpy as np

logger = logging.getLogger(__name__)

GREEN = (0, 200, 0)
RED = (200, 0, 0)


def draw_border(frame: np.ndarray, success: bool, width: int = 4) -> np.ndarray:
    out = frame.copy()
    color = GREEN if success else RED
    out[:width], out[-width:], out[:, :width], out[:, -width:] = color, color, color, color
    return out


def draw_caption(frame: np.ndarray, text: str) -> np.ndarray:
    import cv2

    out = frame.copy()
    cv2.putText(out, text, (4, out.shape[0] - 8), cv2.FONT_HERSHEY_SIMPLEX,
                0.35 * out.shape[1] / 200, (255, 255, 255), 1, cv2.LINE_AA)
    return out


class RolloutVideo:
    def __init__(self, out_dir, fps: int = 15, tag_prefix: str = "rollout"):
        self.out_dir = Path(out_dir)
        self.fps = fps
        self.tag_prefix = tag_prefix
        self._frames: List[np.ndarray] = []
        self._videos: Dict[str, np.ndarray] = {}

    def new_video(self) -> None:
        self._frames = []

    def update(self, rgb_static: np.ndarray) -> None:
        self._frames.append(np.asarray(rgb_static, np.uint8))

    def add_goal_thumbnail(self, goal_img: np.ndarray) -> None:
        if not self._frames:
            return
        import cv2

        h, w = self._frames[-1].shape[:2]
        thumb = cv2.resize(np.asarray(goal_img, np.uint8), (w // 4, h // 4))
        for f in self._frames:
            f[: h // 4, -w // 4:] = thumb

    def draw_outcome(self, success: bool) -> None:
        self._frames = [draw_border(f, success) for f in self._frames]

    def add_language_instruction(self, text: str) -> None:
        self._frames = [draw_caption(f, text) for f in self._frames]

    def finish_video(self, tag: str) -> None:
        if not self._frames:
            return
        self._videos[tag] = np.stack(self._frames)
        self._frames = []

    def write(self, step: int) -> List[Path]:
        """Write every finished video as ``<tag_prefix>_<tag>_step<step>.mp4``
        (``.gif`` where no mp4 writer is available); returns the paths."""
        import imageio

        self.out_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for tag, frames in self._videos.items():
            path = self.out_dir / f"{self.tag_prefix}_{tag}_step{step}.mp4"
            try:
                imageio.mimwrite(path, frames, fps=self.fps, macro_block_size=1)
            except Exception as e:  # noqa: BLE001 - e.g. no ffmpeg: a gif instead
                path.unlink(missing_ok=True)
                path = path.with_suffix(".gif")
                imageio.mimwrite(path, frames, duration=1.0 / self.fps)
                logger.warning("mp4 writer unavailable (%s): wrote %s", e, path.name)
            paths.append(path)
        self._videos.clear()
        return paths
