"""Window dataset: sample idx -> fixed-shape raw numpy window
(``hulc2_tpu/data/window_dataset.py``).

The port's numpy copy, without within-window frame skipping (``frame_skip``,
which the flagship leaves off and the device-store path refuses). Host-side
counterpart of the reference's BaseDataset window sampling + padding
(reference: hulc2/datasets/base_dataset.py:94-163), with transforms removed:
the host emits raw uint8/float arrays padded to ``max_window_size``; all
normalization and augmentation happens on the device.

Padding semantics match the reference exactly (base_dataset.py:121-147):
observations repeat the last frame; relative actions zero-pad all but the
gripper dim which repeats; absolute actions repeat.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from hulc2_torch.data.episode_index import EpisodeIndex


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

    Sample keys: per-camera rgb (S,H,W,3) uint8 / depth (S,H,W) f32,
    ``robot_obs_raw`` (S,15) f32, optional ``scene_obs`` (S,24) f32,
    ``actions`` (S,A) f32, ``seq_len`` int32, ``idx`` int64, and for language
    datasets ``lang`` (token ids (77,) int32, or an embedding (E,) f32),
    ``use_for_aux_lang_loss`` bool and ``lang_task_id`` int32.
    """

    def __init__(self, index: EpisodeIndex, store, observation_space: dict, pad: bool = True,
                 seed: int = 0):
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
        self.padded_size = index.max_window_size

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        window_size = self.index.window_size(idx, self.rng)
        start = int(self.index.episode_lookup[idx])
        ep = self.store.load_window(start, window_size)
        pad = (self.padded_size - window_size) if self.pad else 0

        out: Dict[str, np.ndarray] = {}
        for cam in self.obs_space["rgb_obs"]:
            out[cam] = _pad_repeat(np.ascontiguousarray(ep[cam]), pad)
        for cam in self.obs_space["depth_obs"]:
            out[cam] = _pad_repeat(np.asarray(ep[cam], np.float32), pad)
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
        dataset's keys (images uint8: conversion to float happens on the
        device)."""
        s = self.padded_size
        probe = self.store.load_window(int(self.index.episode_lookup[0]), 1)
        specs: Dict[str, tuple] = {}
        for cam in self.obs_space["rgb_obs"]:
            specs[cam] = ((batch, s, *probe[cam].shape[1:]), np.uint8)
        for cam in self.obs_space["depth_obs"]:
            specs[cam] = ((batch, s, *probe[cam].shape[1:]), np.float32)
        specs["robot_obs_raw"] = ((batch, s, probe["robot_obs"].shape[-1]), np.float32)
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
        shared ``self.rng``."""
        rng = np.random.default_rng((self.seed, epoch, idx))
        ws = self.index.window_size(idx, rng)
        start = int(self.index.episode_lookup[idx])
        # the store reads the window's frames straight into the row's leading
        # ws frames; the padding repeats the last one
        rows = {cam: out[cam][row] for cam in (list(self.obs_space["rgb_obs"])
                                               + list(self.obs_space["depth_obs"]))}
        rows["robot_obs"] = out["robot_obs_raw"][row]
        rows[self.action_key] = out["actions"][row]
        self.store.read_window_into(start, ws, {k: dst[:ws] for k, dst in rows.items()})

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
