"""Frame storage: per-frame .npz files and a RAM or shared-memory cache
(``hulc2_tpu/data/frame_store.py``).

``NpzFrameStore`` reads frames from the dataset's per-frame ``.npz`` files:
``load_frame`` one frame with ``np.load``, ``read_window_into`` a window of
frames per key through the native loader (``data/native_loader.py``, C++
without the GIL) straight into a batch row: the training path without the
device store reads every window so (``WindowDataset.write_into``). An entry
lands in its row as stored (the port's datasets keep ``depth_static`` in
float16, which the transform widens on the device).
``RamFrameStore`` holds a whole split in one contiguous numpy array per key,
indexed by absolute frame id, with zero-copy window views
(``read_window_into`` copies them); with ``use_shm`` the arrays live in named
shared-memory segments keyed by the dataset's path, so that other trainer
processes on the host attach instead of loading again, and segments left
behind by a crashed run are unlinked before new ones are made (the
reference's SharedMemoryLoader, ``shared_memory_loader.py:43-246``).
"""
from __future__ import annotations

import atexit
import logging
import os
import re
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import shared_memory
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from hulc2_torch.data import native_loader

logger = logging.getLogger(__name__)


class NpzFrameStore:
    """Direct per-frame .npz reading (the reference NpzDataset path,
    npz_dataset.py:53-115). Discovers the ``episode_{idx:07d}.npz`` naming
    pattern from the directory contents."""

    def __init__(self, data_dir: Path, keys: Sequence[str]):
        self.data_dir = Path(data_dir)
        self.keys = list(keys)
        self.prefix, self.suffix, self.n_digits, self._first = self._naming_pattern()
        self._specs: Optional[Dict[str, tuple]] = None

    def _naming_pattern(self):
        for entry in sorted(os.scandir(self.data_dir), key=lambda e: e.name):
            p = Path(entry.path)
            if p.suffix == ".npz" and "camera" not in p.stem:
                digits = re.findall(r"\d+", p.stem)
                stem_prefix = re.split(r"\d+", p.stem)[0]
                return str(p.parent / stem_prefix), p.suffix, len(digits[0]), int(digits[-1])
        raise FileNotFoundError(f"no frame .npz files in {self.data_dir}")

    def frame_path(self, idx: int) -> str:
        return f"{self.prefix}{idx:0{self.n_digits}d}{self.suffix}"

    def load_frame(self, idx: int) -> Dict[str, np.ndarray]:
        with np.load(self.frame_path(idx)) as z:
            return {k: z[k] for k in self.keys if k in z.files}

    def frame_specs(self) -> Dict[str, tuple]:
        """(shape, dtype) per key, probed once from the directory's first frame."""
        if self._specs is None:
            probe = self.load_frame(self._first)
            self._specs = {k: (v.shape, v.dtype) for k, v in probe.items()}
        return self._specs

    def load_window(self, start: int, size: int) -> Dict[str, np.ndarray]:
        """Frames ``start .. start + size - 1`` as one (size, ...) array per
        key, read by the native loader (``hulc2_tpu/data/frame_store.py:68-85``)."""
        out = {k: np.empty((size, *shape), dtype) for k, (shape, dtype) in self.frame_specs().items()}
        self.read_window_into(start, size, out)
        return out

    def read_window_into(self, start: int, size: int, out: Dict[str, np.ndarray]) -> None:
        """Read frames ``start .. start + size - 1`` of each key of ``out``
        straight into ``out[key]``, a C-contiguous (size, ...) array (a
        batch row's leading frames), by the native loader in the calling
        thread: ``FusedBatchLoader``'s pool reads its windows in parallel,
        and threads of the loader's own on top of it (JAX starts two per
        core for every window) oversubscribe the cores, which made a batch
        several times slower."""
        self.read_frames_into(range(start, start + size), out)

    def read_frames_into(self, frame_ids, out: Dict[str, np.ndarray]) -> None:
        """``read_window_into`` of the frames ``frame_ids``, in their order
        (the kept frames of a skipped window)."""
        paths = [self.frame_path(int(i)) for i in frame_ids]
        for k, dst in out.items():
            native_loader.load_frames_into(paths, k, dst, n_threads=1)

    def load_window_plain(self, start: int, size: int) -> Dict[str, np.ndarray]:
        """``load_window`` by ``np.load`` frame by frame: the reference the
        native reads are tested against."""
        frames = [self.load_frame(start + i) for i in range(size)]
        return {k: np.stack([f[k] for f in frames]) for k in frames[0]}


class RamFrameStore:
    """Whole-split cache with O(1) zero-copy window views.

    Frames are loaded once (a thread pool: np.load releases the GIL on IO)
    into one contiguous array per key, indexed by ``id_to_row[frame_id]``.
    With ``use_shm`` the arrays are named shared-memory segments
    ``hulc2_<tag>_<key>``, ``tag`` by default the dataset path's tail: a
    second store of the same split attaches to them without loading, the
    store that made them unlinks them in ``cleanup`` (at exit, or when its
    owner calls it)."""

    def __init__(self, npz_store: NpzFrameStore, ep_start_end_ids: np.ndarray,
                 keys: Sequence[str], use_shm: bool = False, shm_tag: Optional[str] = None,
                 num_workers: int = 8):
        self.keys = list(keys)
        self.ranges = [(int(s), int(e)) for s, e in ep_start_end_ids]
        frame_ids: List[int] = []
        for s, e in self.ranges:
            frame_ids.extend(range(s, e + 1))
        self.frame_ids = np.asarray(frame_ids, np.int64)
        self.id_to_row = {int(f): i for i, f in enumerate(frame_ids)}
        self.arrays: Dict[str, np.ndarray] = {}
        self._shms: List[shared_memory.SharedMemory] = []
        self.owner = False
        self._load(npz_store, use_shm, shm_tag, num_workers)
        if self.owner:
            atexit.register(self.cleanup)

    def _load(self, store: NpzFrameStore, use_shm: bool, tag: Optional[str], num_workers: int):
        probe = store.load_frame(int(self.frame_ids[0]))
        n = len(self.frame_ids)
        specs = {k: ((n, *probe[k].shape), probe[k].dtype) for k in self.keys if k in probe}
        if use_shm:
            tag = tag or re.sub(r"\W+", "_", str(store.data_dir))[-48:]
            if self._try_attach(tag, specs):
                logger.info("attached to the shared-memory cache %s", tag)
                return
            self.owner = True
            for k, (shape, dtype) in specs.items():
                name = f"hulc2_{tag}_{k}"
                self._unlink_stale(name)
                nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
                shm = shared_memory.SharedMemory(name=name, create=True, size=nbytes)
                self._shms.append(shm)
                self.arrays[k] = np.ndarray(shape, dtype, buffer=shm.buf)
        else:
            for k, (shape, dtype) in specs.items():
                self.arrays[k] = np.empty(shape, dtype)

        def fill(row: int):
            frame = store.load_frame(int(self.frame_ids[row]))
            for k in self.arrays:
                self.arrays[k][row] = frame[k]

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            list(pool.map(fill, range(n)))
        logger.info("%s cache: %d frames, %.2f GiB", "shared-memory" if use_shm else "RAM", n,
                    sum(a.nbytes for a in self.arrays.values()) / 2**30)

    def _try_attach(self, tag: str, specs) -> bool:
        """Attach to every key's segment; False, holding none, when one is
        missing or too small for the split (a stale segment of another run)."""
        for k, (shape, dtype) in specs.items():
            try:
                shm = shared_memory.SharedMemory(name=f"hulc2_{tag}_{k}")
            except FileNotFoundError:
                break
            self._shms.append(shm)
            if shm.size < int(np.prod(shape)) * np.dtype(dtype).itemsize:
                break
            self.arrays[k] = np.ndarray(shape, dtype, buffer=shm.buf)
        else:
            return True
        self.arrays.clear()
        for shm in self._shms:
            shm.close()
        self._shms.clear()
        return False

    @staticmethod
    def _unlink_stale(name: str) -> None:
        try:
            stale = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            return
        stale.close()
        stale.unlink()
        logger.warning("unlinked the stale shared-memory segment %s", name)

    def cleanup(self) -> None:
        """Close the segments; the store that made them also unlinks them."""
        self.arrays.clear()  # the views must go before their buffers close
        for shm in self._shms:
            try:
                shm.close()
            except BufferError:  # a window view is still alive; the mapping goes at exit
                pass
            if self.owner:
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
        self._shms.clear()

    def drop_arrays(self, keys: Sequence[str]) -> None:
        """Free the host copies of ``keys`` (after a device upload makes them
        dead weight); a shared-memory store keeps them for the processes
        attached to it."""
        if self._shms:
            return
        for k in keys:
            self.arrays.pop(k, None)

    def load_window(self, start: int, size: int) -> Dict[str, np.ndarray]:
        row = self.id_to_row[int(start)]
        return {k: a[row: row + size] for k, a in self.arrays.items()}  # views

    def read_window_into(self, start: int, size: int, out: Dict[str, np.ndarray]) -> None:
        """Copy the window's frames of each key of ``out`` into ``out[key]``."""
        row = self.id_to_row[int(start)]
        for k, dst in out.items():
            dst[...] = self.arrays[k][row: row + size]

    def read_frames_into(self, frame_ids, out: Dict[str, np.ndarray]) -> None:
        """Copy the frames ``frame_ids`` of each key of ``out``, in their
        order, into ``out[key]``."""
        rows = [self.id_to_row[int(i)] for i in frame_ids]
        for k, dst in out.items():
            dst[...] = self.arrays[k][rows]
