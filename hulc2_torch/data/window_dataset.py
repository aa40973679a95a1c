"""Window dataset: sample idx -> fixed-shape raw numpy window
(``hulc2_tpu/data/window_dataset.py``).

The port's numpy copy, with within-window frame skipping (``frame_skip``,
``data/frame_skip.py``; the device-store path refuses it). Host-side
counterpart of the reference's BaseDataset window sampling + padding
(reference: hulc2/datasets/base_dataset.py:94-163), with transforms removed:
the host emits raw arrays padded to ``max_window_size`` (to the effective
maximum when skipping frames); all normalization and augmentation happens on
the device. Depth maps keep the dtype they are stored in (float16 in the
port's datasets, float32 in JAX's batches; the transform widens them on the
device), which halves their host bytes. ``scene_obs`` is carried wherever
the observation space names it: JAX's fused writer leaves it out
(``hulc2_tpu/data/window_dataset.py:133-190``), the port's does not.

Padding semantics match the reference exactly (base_dataset.py:121-147):
observations repeat the last frame; relative actions zero-pad all but the
gripper dim which repeats; absolute actions repeat.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from hulc2_torch.data.episode_index import EpisodeIndex
from hulc2_torch.data.frame_skip import FrameSkip


def _pad_repeat(x: np.ndarray, pad: int) -> np.ndarray:
    if pad == 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)


def _pad_zeros(x: np.ndarray, pad: int) -> np.ndarray:
    if pad == 0:
        return x
    return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)], axis=0)


class WindowDataset:
    """Produces padded window dicts of raw arrays.

    Sample keys: per-camera rgb (S,H,W,3) uint8 / depth (S,H,W) as stored,
    ``robot_obs_raw`` (S,15) f32, optional ``scene_obs`` (S,24) f32,
    ``actions`` (S,A) f32, ``seq_len`` int32, ``idx`` int64, and for language
    datasets ``lang`` (token ids (77,) int32, or an embedding (E,) f32),
    ``use_for_aux_lang_loss`` bool and ``lang_task_id`` int32.
    """

    def __init__(self, index: EpisodeIndex, store, observation_space: dict, pad: bool = True,
                 seed: int = 0, frame_skip: Optional[FrameSkip] = None):
        self.index = index
        self.store = store  # NpzFrameStore | RamFrameStore
        self.obs_space = observation_space
        self._lang_tokens = None  # lazy CLIP-BPE table for string annotations
        self._task_id_table = None  # lazy annotation-row -> task-id table
        self.pad = pad
        self.relative_actions = "rel_actions" in observation_space["actions"]
        self.action_key = observation_space["actions"][0]
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.frame_skip = frame_skip
        if frame_skip is not None and frame_skip.strategy == "diff" and not self.relative_actions:
            raise ValueError("frame_skip strategy 'diff' requires rel_actions")
        # windows pad to the effective maximum when skipping (the reference's
        # ShmDatasetSkip.get_pad_size)
        self.padded_size = (frame_skip.effective_max_ws if frame_skip is not None
                            else index.max_window_size)
        self.with_scene = "scene_obs" in observation_space.get("state_obs", ())

    def _apply_skip(self, ep: Dict[str, np.ndarray], rng) -> Dict[str, np.ndarray]:
        """Subsample every per-frame array of the raw window down to the
        effective window (shm_dataset_skip.py:157-171)."""
        ids = self.frame_skip.keep_ids(np.asarray(ep[self.action_key], np.float32),
                                       self.index.min_window_size, self.index.max_window_size, rng)
        return {k: v[ids] for k, v in ep.items()}

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        window_size = self.index.window_size(idx, self.rng)
        start = int(self.index.episode_lookup[idx])
        ep = self.store.load_window(start, window_size)
        if self.frame_skip is not None:
            ep = self._apply_skip(ep, self.rng)
            window_size = len(ep[self.action_key])
        pad = (self.padded_size - window_size) if self.pad else 0

        out: Dict[str, np.ndarray] = {}
        for cam in list(self.obs_space["rgb_obs"]) + list(self.obs_space["depth_obs"]):
            out[cam] = _pad_repeat(np.ascontiguousarray(ep[cam]), pad)
        out["robot_obs_raw"] = _pad_repeat(np.asarray(ep["robot_obs"], np.float32), pad)
        if "scene_obs" in ep:
            out["scene_obs"] = _pad_repeat(np.asarray(ep["scene_obs"], np.float32), pad)

        acts = np.asarray(ep[self.action_key], np.float32)
        if self.relative_actions:
            acts = np.concatenate(
                [_pad_zeros(acts[:, :-1], pad), _pad_repeat(acts[:, -1:], pad)], axis=-1
            )
        else:
            acts = _pad_repeat(acts, pad)
        out["actions"] = acts
        out["seq_len"] = np.int32(window_size)
        out["idx"] = np.int64(idx)

        if self.index.with_lang:
            ann_row = int(self.index.lang_lookup[idx])
            out["lang"] = self._lang_value(ann_row)
            out["use_for_aux_lang_loss"] = np.bool_(self.index.use_for_aux_lang_loss(idx))
            out["lang_task_id"] = np.int32(self._lang_task_id(ann_row))
        return out

    def _lang_task_id(self, ann_row: int) -> int:
        """Task index of an annotation row (label for the LangTaskHead aux
        loss; -1 when unknown). Mapped once against the canonical task list."""
        if self._task_id_table is None:
            from hulc2_torch.evaluation.tasks import TASK_NAMES

            lut = {t: i for i, t in enumerate(TASK_NAMES)}
            tasks = self.index.lang_tasks or []
            self._task_id_table = np.asarray([lut.get(str(t), -1) for t in tasks], np.int32)
        return int(self._task_id_table[ann_row]) if len(self._task_id_table) else -1

    def out_specs(self, batch: int) -> Dict[str, tuple]:
        """(shape, dtype) of preallocated fused-batch buffers for this
        dataset's keys (images uint8 and depth maps as stored: conversion to
        float happens on the device)."""
        s = self.padded_size
        probe = self.store.load_window(int(self.index.episode_lookup[0]), 1)
        specs: Dict[str, tuple] = {}
        for cam in self.obs_space["rgb_obs"]:
            specs[cam] = ((batch, s, *probe[cam].shape[1:]), np.uint8)
        for cam in self.obs_space["depth_obs"]:
            specs[cam] = ((batch, s, *probe[cam].shape[1:]), probe[cam].dtype)
        specs["robot_obs_raw"] = ((batch, s, probe["robot_obs"].shape[-1]), np.float32)
        if self.with_scene:
            specs["scene_obs"] = ((batch, s, probe["scene_obs"].shape[-1]), np.float32)
        specs["actions"] = ((batch, s, probe[self.action_key].shape[-1]), np.float32)
        if self.index.with_lang:
            lang0 = self._lang_value(0)
            specs["lang"] = ((batch, lang0.shape[-1]), lang0.dtype)
            specs["use_for_aux_lang_loss"] = ((batch,), np.bool_)
            specs["lang_task_id"] = ((batch,), np.int32)
        return specs

    def write_into(self, idx: int, out: Dict[str, np.ndarray], row: int, epoch: int = 0) -> None:
        """Write sample ``idx``'s padded window into row ``row`` of
        preallocated batch buffers. Thread-safe: the train window size draws
        from a stateless per-(seed, epoch, idx) Generator instead of the
        shared ``self.rng``. With frame skipping the window's actions are
        read first, and the other keys of its kept frames only."""
        rng = np.random.default_rng((self.seed, epoch, idx))
        ws = self.index.window_size(idx, rng)
        start = int(self.index.episode_lookup[idx])
        # the store reads the window's frames straight into the row's leading
        # ws frames; the padding repeats the last one
        rows = {cam: out[cam][row] for cam in (list(self.obs_space["rgb_obs"])
                                               + list(self.obs_space["depth_obs"]))}
        rows["robot_obs"] = out["robot_obs_raw"][row]
        if self.with_scene:
            rows["scene_obs"] = out["scene_obs"][row]
        rows[self.action_key] = out["actions"][row]
        if self.frame_skip is None:
            self.store.read_window_into(start, ws, {k: dst[:ws] for k, dst in rows.items()})
        else:
            acts = rows.pop(self.action_key)
            raw = np.empty((ws, *acts.shape[1:]), acts.dtype)
            self.store.read_window_into(start, ws, {self.action_key: raw})
            ids = self.frame_skip.keep_ids(raw, self.index.min_window_size,
                                           self.index.max_window_size, rng)
            ws = len(ids)
            acts[:ws] = raw[ids]
            self.store.read_frames_into(start + np.asarray(ids),
                                        {k: dst[:ws] for k, dst in rows.items()})
            rows[self.action_key] = acts

        for k, dst in rows.items():
            if k != self.action_key:
                dst[ws:] = dst[ws - 1]
        dst = rows[self.action_key]
        if self.relative_actions:  # zero-pad rel dims, repeat the gripper
            dst[ws:, -1] = dst[ws - 1, -1]
            dst[ws:, :-1] = 0.0
        else:
            dst[ws:] = dst[ws - 1]

        if self.index.with_lang:
            ann_row = int(self.index.lang_lookup[idx])
            out["lang"][row] = self._lang_value(ann_row)
            out["use_for_aux_lang_loss"][row] = bool(self.index.use_for_aux_lang_loss(idx))
            out["lang_task_id"][row] = self._lang_task_id(ann_row)

    def _lang_value(self, ann_row: int) -> np.ndarray:
        """Precomputed embedding (E,) f32, or, when the index loaded raw
        annotation strings (load_lang_embeddings=False, the flagship's
        in-graph text tower), CLIP BPE token ids (77,) int32 tokenized once per
        annotation."""
        ann = self.index.lang_ann[ann_row]
        if isinstance(ann, str) or self.index.lang_ann.dtype == object:
            if self._lang_tokens is None:
                from hulc2_torch.utils.clip_tokenizer import tokenize

                self._lang_tokens = tokenize([str(a) for a in self.index.lang_ann])
            return self._lang_tokens[ann_row]
        return np.asarray(ann, np.float32)
