"""Within-window temporal frame skipping (the reference's ShmDatasetSkip;
the port's copy of ``hulc2_tpu/data/frame_skip.py``, the same draws from the
same ``np.random.Generator``).

Reference: hulc2/datasets/shm_dataset_skip.py — a window of raw length
``ws`` in [min_window_size, max_window_size] is subsampled down to an
*effective* window of length linearly mapped into
[effective_min_ws, effective_max_ws], using one of two strategies:

- ``random``: drop a uniformly-sampled fraction of frames anywhere in a
  contiguous sub-span (shm_dataset_skip.py:68-93).
- ``diff``: drop only frames whose relative action barely changes —
  xyz cosine similarity above ``pos_threshold`` AND mean euler-angle delta
  below ``orn_threshold`` AND the gripper action unchanged in the current and
  previous 4 frames; never two consecutive frames; then take a random
  contiguous effective-length slice (shm_dataset_skip.py:95-155).

Host-side pure numpy (the reference routed the xyz cosine through torch;
there is no reason to touch a tensor library for a per-sample 32-row dot
product). Draws come from the caller's ``np.random.Generator`` so the fused
loader's stateless per-(seed, epoch, idx) streams keep batches reproducible
and thread-safe.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FrameSkip:
    """Config + strategy dispatch. ``keep_ids`` returns sorted indices into a
    raw window of length ``ws``; always exactly ``effective_size(ws, ...)``
    of them."""

    strategy: str  # "random" | "diff"
    effective_min_ws: int
    effective_max_ws: int
    pos_threshold: float = 0.99
    orn_threshold: float = 0.08
    min_skip_ratio: float = 0.0
    max_skip_ratio: float = 0.3

    def __post_init__(self):
        if self.strategy not in ("random", "diff"):
            raise ValueError(f"frame_skip.strategy must be random|diff, got {self.strategy!r}")
        if self.effective_min_ws > self.effective_max_ws:
            raise ValueError("effective_min_ws > effective_max_ws")
        if self.strategy == "random" and self.min_skip_ratio > self.max_skip_ratio:
            raise ValueError("min_skip_ratio > max_skip_ratio")

    def effective_size(self, ws: int, min_ws: int, max_ws: int) -> int:
        """Linear map of the raw window length into the effective range
        (shm_dataset_skip.py:82-86); int truncation like the reference."""
        if max_ws == min_ws:
            return self.effective_max_ws
        frac = (ws - min_ws) / (max_ws - min_ws)
        return int(frac * (self.effective_max_ws - self.effective_min_ws) + self.effective_min_ws)

    def keep_ids(
        self,
        rel_actions: np.ndarray,  # (ws, A) — last dim is the gripper
        min_ws: int,
        max_ws: int,
        rng: np.random.Generator,
    ) -> np.ndarray:
        ws = len(rel_actions)
        eff = self.effective_size(ws, min_ws, max_ws)
        if eff >= ws:
            return np.arange(ws)
        if self.strategy == "random":
            return self._random_ids(ws, eff, rng)
        return self._diff_ids(rel_actions, eff, rng)

    # ------------------------------------------------------------------ #
    def _random_ids(self, ws: int, eff: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform skip fraction inside a random contiguous pre-skip span
        (shm_dataset_skip.py:68-93), clamped so short windows degrade to
        fewer skips instead of raising."""
        n_skip = int(rng.integers(int(ws * self.min_skip_ratio), int(ws * self.max_skip_ratio) + 1))
        n_skip = min(n_skip, ws - eff)
        span = eff + n_skip
        pre = int(rng.integers(0, ws - span)) if ws > span else 0
        return np.sort(rng.choice(np.arange(pre, pre + span), eff, replace=False))

    def _diff_ids(self, rel_actions: np.ndarray, eff: int, rng: np.random.Generator) -> np.ndarray:
        ws = len(rel_actions)
        a, b = rel_actions[:-1], rel_actions[1:]

        # xyz direction similarity between consecutive relative actions
        dot = np.sum(a[:, :3] * b[:, :3], axis=1)
        norm = np.linalg.norm(a[:, :3], axis=1) * np.linalg.norm(b[:, :3], axis=1)
        pos_cos = dot / np.maximum(norm, 1e-8)
        skippable_pos = np.where(pos_cos > self.pos_threshold)[0] + 1

        orn_diff = np.mean(np.abs(a[:, 3:6] - b[:, 3:6]), axis=1)
        skippable_orn = np.where(orn_diff < self.orn_threshold)[0] + 1

        # protect the 4 frames from each gripper toggle onward
        toggles = np.where(a[:, -1] != b[:, -1])[0] + 1
        protected = np.unique(toggles[:, None] + np.arange(4)[None, :]) if len(toggles) else np.empty(0, int)
        unprotected = np.setdiff1d(np.arange(ws), protected)

        candidates = np.intersect1d(np.intersect1d(skippable_pos, skippable_orn), unprotected)
        # never skip two consecutive frames: from each run of consecutive
        # candidates keep every other one (shm_dataset_skip.py:144-146)
        adjacent = candidates[np.where(candidates[1:] == candidates[:-1] + 1)] if len(candidates) > 1 else np.empty(0, int)
        candidates = np.setdiff1d(candidates, np.union1d(adjacent, adjacent + 1)[1::2])

        max_skip = min(len(candidates), ws - eff)
        n_skip = int(rng.integers(int(max_skip * self.min_skip_ratio), max_skip + 1))
        skip = rng.choice(candidates, n_skip, replace=False) if n_skip else np.empty(0, int)
        kept = np.delete(np.arange(ws), skip)
        start = int(rng.integers(0, len(kept) - eff + 1))
        return kept[start : start + eff]


def make_frame_skip(cfg) -> FrameSkip | None:
    """Build from a datamodule ``frame_skip`` sub-config dict (None → off)."""
    if not cfg:
        return None
    return FrameSkip(
        strategy=cfg["strategy"],
        effective_min_ws=cfg["effective_min_ws"],
        effective_max_ws=cfg["effective_max_ws"],
        pos_threshold=cfg.get("pos_threshold", 0.99),
        orn_threshold=cfg.get("orn_threshold", 0.08),
        min_skip_ratio=cfg.get("min_skip_ratio", 0.0),
        max_skip_ratio=cfg.get("max_skip_ratio", 0.3),
    )
