"""Frame storage: per-frame .npz files and a RAM cache (``hulc2_tpu/data/frame_store.py``).

The port's numpy copy of ``NpzFrameStore`` and ``RamFrameStore``: one
contiguous numpy array per modality indexed by absolute frame id, with
zero-copy window views. The shared-memory cache (``use_shm``) and the native
npz loader are not ported; asking for the former raises.
"""
from __future__ import annotations

import logging
import os
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class NpzFrameStore:
    """Direct per-frame .npz reading (the reference NpzDataset path,
    npz_dataset.py:53-115). Discovers the ``episode_{idx:07d}.npz`` naming
    pattern from the directory contents."""

    def __init__(self, data_dir: Path, keys: Sequence[str]):
        self.data_dir = Path(data_dir)
        self.keys = list(keys)
        self.prefix, self.suffix, self.n_digits = self._naming_pattern()

    def _naming_pattern(self):
        for entry in sorted(os.scandir(self.data_dir), key=lambda e: e.name):
            p = Path(entry.path)
            if p.suffix == ".npz" and "camera" not in p.stem:
                digits = re.findall(r"\d+", p.stem)
                stem_prefix = re.split(r"\d+", p.stem)[0]
                return str(p.parent / stem_prefix), p.suffix, len(digits[0])
        raise FileNotFoundError(f"no frame .npz files in {self.data_dir}")

    def frame_path(self, idx: int) -> str:
        return f"{self.prefix}{idx:0{self.n_digits}d}{self.suffix}"

    def load_frame(self, idx: int) -> Dict[str, np.ndarray]:
        with np.load(self.frame_path(idx)) as z:
            return {k: z[k] for k in self.keys if k in z.files}

    def load_window(self, start: int, size: int) -> Dict[str, np.ndarray]:
        frames = [self.load_frame(start + i) for i in range(size)]
        return {k: np.stack([f[k] for f in frames]) for k in frames[0]}


class RamFrameStore:
    """Whole-split RAM cache with O(1) zero-copy window views.

    Frames are loaded once (a thread pool: np.load releases the GIL on IO)
    into one contiguous array per modality, indexed by ``id_to_row[frame_id]``.
    """

    def __init__(self, npz_store: NpzFrameStore, ep_start_end_ids: np.ndarray,
                 keys: Sequence[str], use_shm: bool = False, num_workers: int = 8):
        if use_shm:
            raise NotImplementedError("the shared-memory frame cache is not ported")
        self.keys = list(keys)
        self.ranges = [(int(s), int(e)) for s, e in ep_start_end_ids]
        frame_ids: List[int] = []
        for s, e in self.ranges:
            frame_ids.extend(range(s, e + 1))
        self.frame_ids = np.asarray(frame_ids, np.int64)
        self.id_to_row = {int(f): i for i, f in enumerate(frame_ids)}
        self.arrays: Dict[str, np.ndarray] = {}
        self._load(npz_store, num_workers)

    def _load(self, store: NpzFrameStore, num_workers: int) -> None:
        probe = store.load_frame(int(self.frame_ids[0]))
        n = len(self.frame_ids)
        for k in self.keys:
            if k in probe:
                self.arrays[k] = np.empty((n, *probe[k].shape), probe[k].dtype)

        def fill(row: int):
            frame = store.load_frame(int(self.frame_ids[row]))
            for k in self.arrays:
                self.arrays[k][row] = frame[k]

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            list(pool.map(fill, range(n)))
        logger.info("RAM cache: %d frames, %.2f GiB", n,
                    sum(a.nbytes for a in self.arrays.values()) / 2**30)

    def drop_arrays(self, keys: Sequence[str]) -> None:
        """Free the host copies of ``keys`` (after a device upload makes them
        dead weight)."""
        for k in keys:
            self.arrays.pop(k, None)

    def load_window(self, start: int, size: int) -> Dict[str, np.ndarray]:
        row = self.id_to_row[int(start)]
        return {k: a[row : row + size] for k, a in self.arrays.items()}  # views
