"""The fused training batches the data layer should produce, worked out
from the dataset's files alone (numpy).

Epoch ``e`` of a fused [vis; lang] loader takes its window orders from
``default_rng((seed, e + 1, 0|1)).permutation(n)``, each window's size from
``default_rng((seed, e, idx))`` over [min, max window that fits], pads
observations by repeating the last frame and relative actions with zeros but
the gripper, which repeats; each lang row carries its annotation's CLIP token
ids (or precomputed embedding), its task id and whether it is the last
window of its annotated range (``use_for_aux_lang_loss``). The index is the
frozen copy of the port's ``episode_index``, built from the split's files
or from a tiled index (``harness/dataset.tile_index``), whose frame id ``i``
is the split's frame ``i % period``. Frames are read from the npz files
with ``np.load``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from portbench.reference.port.data import episode_index as ei
from portbench.reference.port.evaluation.tasks import TASK_NAMES
from portbench.reference.port.utils.clip_tokenizer import tokenize


class SplitFrames:
    """Every frame of a split in one array per key, indexed by frame id
    (modulo ``period``, where an index tiles the split)."""

    def __init__(self, split_dir: Path, keys, period: Optional[int] = None):
        ranges = ei.load_ep_start_end_ids(split_dir, split_dir.name)
        ids = np.concatenate([np.arange(s, e + 1) for s, e in ranges])
        self.row = {int(i): j for j, i in enumerate(ids)}
        self.period = period
        frames = [np.load(split_dir / f"episode_{int(i):07d}.npz") for i in ids]
        self.arrays = {k: np.stack([f[k] for f in frames]) for k in keys}

    def window(self, key: str, start: int, size: int) -> np.ndarray:
        r = self.row[start % self.period if self.period else start]
        return self.arrays[key][r:r + size]


class ReferenceBatches:
    """The training split's fused batches of a config's datamodule section,
    over the split's own index or the tiled one in ``index_dir``."""

    def __init__(self, dm_cfg: dict, root, seed: int, index_dir=None):
        split_dir = Path(root) / "training"
        index_dir = split_dir if index_dir is None else Path(index_dir)
        period = (json.loads((index_dir / "tiling.json").read_text())["period"]
                  if index_dir != split_dir else None)
        obs = dm_cfg["observation_space"]
        self.cams = list(obs["rgb_obs"])
        self.action_key = obs["actions"][0]
        self.S = dm_cfg["max_window_size"]
        self.bv, self.bl = dm_cfg["batch_size_vis"], dm_cfg["batch_size_lang"]
        self.seed = seed
        lo, hi = dm_cfg["min_window_size"], dm_cfg["max_window_size"]
        self.vis = ei.build_vision_index(index_dir, "training", lo, hi)
        self.lang = ei.build_lang_index(index_dir, "training", lo, hi, dm_cfg["lang_folder"],
                                        aux_lang_loss_window=dm_cfg["aux_lang_loss_window"],
                                        load_lang_embeddings=dm_cfg["load_lang_embeddings"])
        self.frames = SplitFrames(split_dir, self.cams + ["robot_obs", self.action_key], period)
        if dm_cfg["load_lang_embeddings"]:
            self.lang_values = np.asarray(self.lang.lang_ann, np.float32)
        else:
            self.lang_values = tokenize([str(a) for a in self.lang.lang_ann])
        task_ids = {t: i for i, t in enumerate(TASK_NAMES)}
        self.task_ids = np.asarray([task_ids.get(str(t), -1) for t in self.lang.lang_tasks],
                                   np.int32)

    def _row(self, index: ei.EpisodeIndex, idx: int, epoch: int, out: Dict, r: int) -> None:
        ws = index.window_size(idx, np.random.default_rng((self.seed, epoch, idx)))
        start = int(index.episode_lookup[idx])
        pad = self.S - ws
        for cam in self.cams:
            w = self.frames.window(cam, start, ws)
            out[cam][r] = np.concatenate([w, np.repeat(w[-1:], pad, 0)])
        robot = self.frames.window("robot_obs", start, ws)
        out["robot_obs_raw"][r] = np.concatenate([robot, np.repeat(robot[-1:], pad, 0)])
        acts = self.frames.window(self.action_key, start, ws)
        padded = np.zeros((self.S, acts.shape[-1]), np.float32)
        padded[:ws] = acts
        padded[ws:, -1] = acts[-1, -1]
        out["actions"][r] = padded

    def batch(self, epoch: int, b: int) -> Dict[str, np.ndarray]:
        """Batch ``b`` of epoch ``epoch``."""
        ov = np.random.default_rng((self.seed, epoch + 1, 0)).permutation(len(self.vis))
        ol = np.random.default_rng((self.seed, epoch + 1, 1)).permutation(len(self.lang))
        n = self.bv + self.bl
        out = {cam: np.empty((n, self.S, *self.frames.arrays[cam].shape[1:]), np.uint8)
               for cam in self.cams}
        out["robot_obs_raw"] = np.empty((n, self.S, 15), np.float32)
        out["actions"] = np.empty((n, self.S, 7), np.float32)
        for j, idx in enumerate(ov[b * self.bv:(b + 1) * self.bv]):
            self._row(self.vis, int(idx), epoch, out, j)
        langs = ol[b * self.bl:(b + 1) * self.bl]
        for j, idx in enumerate(langs):
            self._row(self.lang, int(idx), epoch, out, self.bv + j)
        ann = self.lang.lang_lookup[langs]
        out["lang"] = self.lang_values[ann]
        out["use_for_aux_lang_loss"] = np.asarray(
            [self.lang.use_for_aux_lang_loss(int(i)) for i in langs], np.bool_)
        out["lang_task_id"] = self.task_ids[ann]
        return out
