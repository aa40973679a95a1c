"""The training batches assembled in a subprocess, handed over through shared
memory (``hulc2_tpu/data/process_loader.py:43-211``;
``datamodule.loader_isolation=process``).

One spawned child rebuilds the datamodule's training split from its config
(``device_store`` off, on the CPU: it never initialises CUDA) and runs the
ordinary ``FusedBatchLoader`` epoch stream, each batch written by the
loader's threads straight into a slot of a ring of named shared-memory
segments (``hulc2_pl_<tag>_<slot>_<key>``). The parent takes the slots in
order, copies each into a slot of its pinned ring (``loader.PinnedRing``;
fresh arrays off the card), frees the shared slot for the child and yields
the batch, which ``DevicePrefetcher`` copies to the card. With the
training split in a shared-memory cache (``--shm-cache``) the child attaches
to its segments instead of loading a second copy.

The stream is JAX's: continuous across epochs, starting at the loader's
``epoch`` when the first batch is asked for, so a full epoch gives
``FusedBatchLoader``'s batches of that epoch and an epoch cut short (by
``trainer.limit_train_batches``) resumes mid-stream at the next call.

Before it makes the slots the loader checks the free space of ``/dev/shm``
and raises with the sizes (a full tmpfs would kill the child with SIGBUS in
the middle of a copy). A child that dies or fails, or no batch within
``TIMEOUT_S``, raises in the parent; ``close()`` (also at exit) stops the
child and unlinks every segment of the ring.
"""
from __future__ import annotations

import atexit
import logging
import multiprocessing as mp
import os
import queue
import shutil
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import shared_memory
from typing import Dict, Iterator, List

import numpy as np

from hulc2_torch.data.loader import FusedBatchLoader, PinnedRing

logger = logging.getLogger(__name__)

SEGMENT_PREFIX = "hulc2_pl_"
SHM_DIR = "/dev/shm"


def _segment(tag: str, slot: int, key: str) -> str:
    return f"{SEGMENT_PREFIX}{tag}_{slot}_{key}"


def _nbytes(spec) -> int:
    shape, dtype = spec
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


def _open_slots(tag: str, n_slots: int, specs: Dict[str, tuple], create: bool):
    """(per slot {key: array view}, the segments)."""
    slots: List[Dict[str, np.ndarray]] = []
    shms: List[shared_memory.SharedMemory] = []
    for s in range(n_slots):
        views = {}
        for k, spec in specs.items():
            shm = shared_memory.SharedMemory(name=_segment(tag, s, k), create=create,
                                             size=_nbytes(spec) if create else 0)
            shms.append(shm)
            views[k] = np.ndarray(spec[0], spec[1], buffer=shm.buf)
        slots.append(views)
    return slots, shms


class _SharedSlots:
    """The child's ring for ``FusedBatchLoader``: slot i is written only
    once the parent has freed it (``free[i]``); a written slot is its index."""

    def __init__(self, slots, free, stop):
        self.slots, self.free, self.stop = slots, free, stop

    def acquire(self, i: int) -> Dict[str, np.ndarray]:
        while not self.free[i].acquire(timeout=0.1):
            if self.stop.is_set():
                raise SystemExit(0)
        return self.slots[i]

    def batch(self, i: int) -> int:
        return i

    def close(self) -> None:
        pass


class _ChildLoader(FusedBatchLoader):
    def __init__(self, *args, shared: _SharedSlots, **kw):
        super().__init__(*args, **kw)
        self.shared = shared

    def _ring(self):
        return self.shared


def _child_main(spec: dict, free, ready, stop) -> None:
    """The child: the datamodule's training split, then the epoch stream
    into the shared slots until the parent stops it."""
    try:
        from hulc2_torch.data.datamodule import Hulc2DataModule

        dm = Hulc2DataModule(spec["dm_cfg"], seed=spec["seed"], device="cpu",
                             use_shm_cache=spec["use_shm_cache"])
        dm.setup(splits=("training",))
        # the segments stay referenced while their views are written
        slots, _segments = _open_slots(spec["tag"], FusedBatchLoader.RING_SLOTS, spec["specs"],
                                       create=False)
        loader = _ChildLoader(dm.datasets["vis_training"], dm.datasets["lang_training"],
                              spec["bv"], spec["bl"], seed=spec["seed"],
                              num_threads=spec["num_threads"],
                              shared=_SharedSlots(slots, free, stop))
        loader.epoch = spec["start_epoch"]
        while not stop.is_set():
            for slot in loader:
                ready.put(slot)
                if stop.is_set():
                    break
    except SystemExit:
        pass
    except Exception:  # the parent raises it at its next batch
        ready.put(("error", traceback.format_exc()))


class ProcessFusedLoader:
    """``FusedBatchLoader``'s stream assembled in a child process (module
    docstring). ``dm_cfg`` is the datamodule's config; ``vis_dataset`` and
    ``lang_dataset`` the parent's training datasets, which give the epoch
    length and the batch's buffer specs."""

    # the shared slots, and the pinned ring of each epoch: the batches
    # assembled ahead and the one being copied, as FusedBatchLoader's ring
    RING_SLOTS = FusedBatchLoader.RING_SLOTS
    TIMEOUT_S = 600.0  # the longest wait for a batch of a live child

    def __init__(self, dm_cfg: dict, vis_dataset, lang_dataset, batch_size_vis: int,
                 batch_size_lang: int, seed: int = 0, use_shm_cache: bool = False,
                 num_threads: int = 4, pin_memory: bool = False):
        shape_of = FusedBatchLoader(vis_dataset, lang_dataset, batch_size_vis, batch_size_lang)
        self.specs, self._len = shape_of.specs, len(shape_of)
        self.pin_memory, self.num_threads = pin_memory, num_threads
        self.epoch = 0
        self.slot_nbytes = sum(_nbytes(s) for s in self.specs.values())
        self.tag = f"{os.getpid()}_{id(self) & 0xFFFFFF:x}"
        self._spec = {
            "dm_cfg": {**dm_cfg, "device_store": False}, "seed": seed,
            "use_shm_cache": use_shm_cache, "bv": batch_size_vis, "bl": batch_size_lang,
            "tag": self.tag, "specs": self.specs,
            "num_threads": num_threads,
        }
        self._proc = None
        self._slots: List[Dict[str, np.ndarray]] = []
        self._shms: List[shared_memory.SharedMemory] = []
        self._closed = False
        atexit.register(self.close)

    def __len__(self) -> int:
        return self._len

    def _check_shm_space(self) -> None:
        need = self.RING_SLOTS * self.slot_nbytes
        free = shutil.disk_usage(SHM_DIR).free
        if free < need:
            raise RuntimeError(
                f"{SHM_DIR} has {free / 2**20:.1f} MiB free; the process loader's "
                f"{self.RING_SLOTS} slots need {need / 2**20:.1f} MiB "
                f"({self.slot_nbytes / 2**20:.1f} MiB a batch)")

    def _start(self) -> None:
        """Make the slots and start the child at the current epoch."""
        self._check_shm_space()
        self._slots, self._shms = _open_slots(self.tag, self.RING_SLOTS, self.specs, create=True)
        ctx = mp.get_context("spawn")  # a forked child would inherit a CUDA context
        self._free = [ctx.Semaphore(1) for _ in range(self.RING_SLOTS)]
        self._ready = ctx.Queue()
        self._stop = ctx.Event()
        self._copy_pool = ThreadPoolExecutor(max_workers=4)
        self._proc = ctx.Process(target=_child_main, daemon=True,
                                 args=({**self._spec, "start_epoch": self.epoch}, self._free,
                                       self._ready, self._stop))
        self._proc.start()
        logger.info("process loader: child pid %d, %d shared slots of %.1f MiB", self._proc.pid,
                    self.RING_SLOTS, self.slot_nbytes / 2**20)

    def _next_slot(self) -> int:
        deadline = time.monotonic() + self.TIMEOUT_S
        while True:
            try:
                item = self._ready.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._proc.is_alive():
                    raise RuntimeError(f"the loader's child process died (exit code "
                                       f"{self._proc.exitcode}) without reporting an error")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the loader's child process gave no batch in "
                                       f"{self.TIMEOUT_S} s")
        if isinstance(item, tuple):
            raise RuntimeError(f"the loader's child process failed:\n{item[1]}")
        return item

    def _copy(self, src: Dict[str, np.ndarray], dst: Dict[str, np.ndarray]) -> None:
        """Copy every key, large ones in four row chunks on the copy pool."""
        jobs = []
        for k, a in src.items():
            parts = np.array_split(np.arange(a.shape[0]), 4) if a.nbytes > 1 << 22 else [None]
            for rows in parts:
                if rows is None:
                    jobs.append((dst[k], a))
                elif len(rows):
                    jobs.append((dst[k][rows[0]:rows[-1] + 1], a[rows[0]:rows[-1] + 1]))
        list(self._copy_pool.map(lambda j: np.copyto(*j), jobs))

    def __iter__(self) -> Iterator[Dict]:
        if self._closed:
            raise RuntimeError("the process loader was closed")
        if self._proc is None:
            self._start()
        self.epoch += 1
        # a ring per call, as FusedBatchLoader's: a consumer that stops early
        # may keep a slot of it
        ring = PinnedRing(self.specs, self.RING_SLOTS) if self.pin_memory else None
        try:
            for b in range(self._len):
                slot = self._next_slot()
                try:
                    if ring is not None:
                        j = b % self.RING_SLOTS
                        self._copy(self._slots[slot], ring.acquire(j))
                        batch = ring.batch(j)
                    else:
                        batch = {k: np.empty(*spec) for k, spec in self.specs.items()}
                        self._copy(self._slots[slot], batch)
                finally:
                    self._free[slot].release()
                yield batch
        finally:
            if ring is not None:
                ring.close()

    def close(self) -> None:
        """Stop the child and unlink every segment of the ring."""
        if self._closed:
            return
        self._closed = True
        if self._proc is not None:
            self._stop.set()
            if self._proc.pid is not None:
                self._proc.join(timeout=5)
                if self._proc.is_alive():
                    self._proc.kill()
                    self._proc.join(timeout=5)
            self._copy_pool.shutdown(wait=False)
        self._slots = []
        for shm in self._shms:
            try:
                shm.close()
            except BufferError:  # a view is still alive; the mapping goes at exit
                pass
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        self._shms = []
