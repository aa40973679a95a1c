"""Episode lookup construction: on-disk episode ranges -> per-sample indices.

The port's copy of ``hulc2_tpu/data/episode_index.py``, unchanged but for its
imports and two checks of the episode ranges, which raise where the JAX
package asserts. Behavior-compatible with the reference's lookup logic (reference:
hulc2/datasets/npz_dataset.py:145-224, hulc2/utils/data_utils.py:6,
hulc2/utils/split_dataset.py:14-52) so the sampling distribution and the
deterministic validation windows match exactly:

- play episodes come from ``ep_start_end_ids.npy`` or ``split.json``
- every frame index i with a full min_window after it inside its episode is a
  valid window start
- language windows come from ``auto_lang_ann.npy``'s ``info.indx`` ranges
- ``data_percent`` truncates the cumulative frame count, trimming the last
  episode (and dropping language windows outside the kept range)
- validation window sizes are FNV1-32-hash deterministic
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from portbench.reference.port.ops.fnv import get_validation_window_size


def load_ep_start_end_ids(data_dir: Path, split: str) -> np.ndarray:
    f = data_dir / "ep_start_end_ids.npy"
    if f.is_file():
        return np.load(f)
    with open(data_dir / "split.json") as fh:
        return np.asarray(json.load(fh)[split])


def apply_data_percent(ep_ids: np.ndarray, data_percent: float) -> np.ndarray:
    """Keep episodes up to data_percent of total frames; trim the last
    (reference: data_utils.py:6-25)."""
    if data_percent >= 1.0:
        return ep_ids
    ep_ids = np.array(ep_ids, copy=True)
    lens = ep_ids[:, 1] - ep_ids[:, 0]
    cumsum = np.cumsum(lens)
    n_samples = int(cumsum[-1] * data_percent)
    keep = [0]
    for i in range(len(cumsum) - 1):
        if cumsum[i] <= n_samples:
            keep.append(i + 1)
    ep_ids = ep_ids[keep]
    diff = cumsum[len(keep) - 1] - n_samples
    ep_ids[-1, 1] -= diff
    return ep_ids


def load_lang_data(data_dir: Path, lang_folder: str) -> dict:
    """auto_lang_ann.npy: {"language": {"ann","task","emb"}, "info": {"indx"}}."""
    for candidate in (data_dir / lang_folder / "auto_lang_ann.npy", data_dir / "auto_lang_ann.npy"):
        if candidate.is_file():
            return np.load(candidate, allow_pickle=True).reshape(-1)[0]
    raise FileNotFoundError(f"no auto_lang_ann.npy under {data_dir} (lang_folder={lang_folder})")


def filter_lang_by_episodes(lang_data: dict, ep_ids: np.ndarray) -> dict:
    """Keep only language windows fully inside kept play episodes
    (reference: split_dataset.py:24-52)."""
    keys = np.asarray([list(ix) for ix in lang_data["info"]["indx"]])
    out = {"language": {"ann": [], "task": [], "emb": []}, "info": {"indx": []}}
    for start, end in ep_ids:
        inside = np.where((keys[:, 0] >= start) & (keys[:, 1] <= end))[0]
        for i in inside:
            out["language"]["ann"].append(lang_data["language"]["ann"][i])
            out["language"]["task"].append(lang_data["language"]["task"][i])
            out["language"]["emb"].append(lang_data["language"]["emb"][i])
            out["info"]["indx"].append(lang_data["info"]["indx"][i])
    out["language"]["emb"] = np.asarray(out["language"]["emb"])
    return out


@dataclass
class EpisodeIndex:
    """Maps sample idx -> (start frame, episode bounds) + window-size sampling."""

    episode_lookup: np.ndarray  # (N,) valid window start frame ids
    min_window_size: int
    max_window_size: int
    validation: bool
    lang_lookup: Optional[np.ndarray] = None  # (N,) -> annotation row
    lang_ann: Optional[np.ndarray] = None  # embeddings (M, 1, E) or strings
    lang_tasks: Optional[List[str]] = None
    aux_lang_loss_window: int = 8

    def __len__(self) -> int:
        return len(self.episode_lookup)

    @property
    def with_lang(self) -> bool:
        return self.lang_lookup is not None

    def max_window(self, idx: int) -> int:
        """Largest window starting at idx that stays inside its episode
        (reference: npz_dataset.py:66-88)."""
        diff = self.max_window_size - self.min_window_size
        lookup = self.episode_lookup
        if len(lookup) <= idx + diff:
            return self.min_window_size + len(lookup) - idx - 1
        if lookup[idx + diff] != lookup[idx] + diff:
            steps = (
                self.min_window_size
                + np.nonzero(lookup[idx : idx + diff + 1] - (lookup[idx] + np.arange(diff + 1)))[0][0]
                - 1
            )
            return min(self.max_window_size, int(steps))
        return self.max_window_size

    def window_size(self, idx: int, rng: np.random.Generator) -> int:
        if self.min_window_size == self.max_window_size:
            return self.max_window_size
        mw = self.max_window(idx)
        if self.validation:
            return get_validation_window_size(idx, self.min_window_size, mw)
        return int(rng.integers(self.min_window_size, mw + 1))

    def use_for_aux_lang_loss(self, idx: int) -> bool:
        """True on the last window of each annotated sequence
        (reference: npz_dataset.py:226-234)."""
        if not self.with_lang:
            return False
        ll = self.lang_lookup
        return bool(
            idx + self.aux_lang_loss_window >= len(ll)
            or ll[idx] < ll[idx + self.aux_lang_loss_window]
        )


def build_vision_index(
    data_dir: Path,
    split: str,
    min_window_size: int,
    max_window_size: int,
    data_percent: float = 1.0,
    skip_frames: int = 1,
) -> EpisodeIndex:
    """``skip_frames > 1`` keeps every k-th window start (the reference's
    ``skip_frames`` dataset arg)."""
    ep_ids = apply_data_percent(load_ep_start_end_ids(data_dir, split), data_percent if split == "training" else 1.0)
    lookup = []
    for start, end in ep_ids:
        if not end > max_window_size:
            raise ValueError(f"episode ({start}, {end}) ends before frame {max_window_size}")
        lookup.extend(range(int(start), int(end) + 1 - min_window_size, max(skip_frames, 1)))
    return EpisodeIndex(
        episode_lookup=np.asarray(lookup, np.int64),
        min_window_size=min_window_size,
        max_window_size=max_window_size,
        validation=(split == "validation"),
    )


def build_lang_index(
    data_dir: Path,
    split: str,
    min_window_size: int,
    max_window_size: int,
    lang_folder: str,
    skip_frames: int = 1,
    data_percent: float = 1.0,
    aux_lang_loss_window: int = 8,
    load_lang_embeddings: bool = True,
    pretrain: bool = False,
) -> EpisodeIndex:
    ep_ids = load_ep_start_end_ids(data_dir, split)
    lang_data = load_lang_data(data_dir, lang_folder)
    lang_data = filter_lang_by_episodes(lang_data, ep_ids)
    if split == "training" and data_percent < 1.0:
        kept = apply_data_percent(ep_ids, data_percent)
        lang_data = filter_lang_by_episodes(lang_data, kept)

    ann_ranges = lang_data["info"]["indx"]
    episode_lookup, lang_lookup = [], []
    for i, (start, end) in enumerate(ann_ranges):
        if pretrain:
            start = max(start, end + 1 - min_window_size - aux_lang_loss_window)
        if not end >= max_window_size:
            raise ValueError(f"annotation ({start}, {end}) ends before frame {max_window_size}")
        cnt = 0
        for idx in range(int(start), int(end) + 1 - min_window_size):
            if cnt % skip_frames == 0:
                lang_lookup.append(i)
                episode_lookup.append(idx)
            cnt += 1
    emb = np.asarray(lang_data["language"]["emb"])
    if emb.ndim == 3:  # (M, 1, E) -> (M, E)
        emb = emb[:, 0]
    return EpisodeIndex(
        episode_lookup=np.asarray(episode_lookup, np.int64),
        min_window_size=min_window_size,
        max_window_size=max_window_size,
        validation=(split == "validation"),
        lang_lookup=np.asarray(lang_lookup, np.int64),
        lang_ann=emb if load_lang_embeddings else np.asarray(lang_data["language"]["ann"], dtype=object),
        lang_tasks=list(lang_data["language"]["task"]),
        aux_lang_loss_window=aux_lang_loss_window,
    )
