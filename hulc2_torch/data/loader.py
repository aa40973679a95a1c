"""Batch loading: threaded window assembly and the device prefetcher
(``hulc2_tpu/data/loader.py``).

``BatchLoader`` (with ``collate`` and ``zip_modalities``) yields the
validation split's {"vis": ..., "lang": ...} numpy batches, and, through
``ModalityLoader``, the training batches of a single-modality config.
``FusedBatchLoader`` assembles the training batches of the path without the
device store on the host: fused [vis; lang] rows, every byte written once
into its final buffer by the thread that read it. For the card those buffers
are pinned and come from a small ring (``PinnedRing``), so that the copy to
the device needs neither a second host copy nor a wait.
``DevicePrefetcher`` runs a training batch stream in a thread: on the card it
makes the stream's device work (the device store's gather) and the copies of
its host arrays on a side stream, from pinned memory without waiting, and the
consumer's stream waits on an event before it reads the batch; a batch from
the ring gets its slot back with the event of its copy. The subprocess loader
is not ported.
"""
from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from hulc2_torch.data.window_dataset import WindowDataset


def collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def process_shard(order: np.ndarray, process_index: int, process_count: int) -> np.ndarray:
    """This process's share of an epoch's order: every ``process_count``-th
    index from ``process_index`` (``hulc2_tpu/data/loader.py:55-62``), disjoint
    across the processes of a data-parallel run."""
    return order[process_index::process_count]


def fused_orders(seed: int, epoch: int, n_vis: int, n_lang: int, process_index: int = 0,
                 process_count: int = 1) -> tuple:
    """The vis and lang orders of a fused loader's epoch, from
    ``default_rng((seed, epoch, 0|1))``, each this process's shard."""
    return tuple(process_shard(np.random.default_rng((seed, epoch, m)).permutation(n),
                               process_index, process_count)
                 for m, n in enumerate((n_vis, n_lang)))


class BatchLoader:
    """Epoch-based batch iterator over a WindowDataset, shuffled or in index
    order; the last partial batch is dropped. In a data-parallel run each
    process takes its ``process_shard`` of the epoch's order, and every
    process the same number of batches, ``len(dataset) // process_count //
    batch_size``."""

    def __init__(self, dataset: WindowDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_threads: int = 4, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.process_count // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self.epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        return process_shard(order, self.process_index, self.process_count)

    def _make(self, idxs) -> Dict[str, np.ndarray]:
        return collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        self.epoch += 1
        nb = len(self)
        batches = [order[b * self.batch_size:(b + 1) * self.batch_size] for b in range(nb)]
        if self.num_threads <= 1:
            for idxs in batches:
                yield self._make(idxs)
            return
        # a sliding window of outstanding futures: bounded memory, and an
        # abandoned iterator leaves at most `window` batches of work behind
        window = self.num_threads * 2
        pool = ThreadPoolExecutor(max_workers=self.num_threads)
        try:
            pending: deque = deque(pool.submit(self._make, idxs) for idxs in batches[:window])
            for idxs in batches[window:] + [None] * len(pending):
                batch = pending.popleft().result()
                if idxs is not None:
                    pending.append(pool.submit(self._make, idxs))
                yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


class ModalityLoader:
    """The training loader of a single-modality config
    (``datamodule/datasets=vision_only|lang_only``): its modality's
    ``BatchLoader``, each batch as {modality: batch}, as JAX routes such a
    config through the per-modality iterator (``hulc2_tpu/data/datamodule.py:129-137``)."""

    def __init__(self, modality: str, loader: BatchLoader):
        self.modality = modality
        self.loader = loader

    @property
    def epoch(self) -> int:
        return self.loader.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self.loader.epoch = value

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Dict[str, Dict]]:
        for batch in self.loader:
            yield {self.modality: batch}


def zip_modalities(modalities, *loaders) -> Iterator[Dict[str, Dict]]:
    """Zip per-modality loaders per step the way Lightning zips the dict of
    DataLoaders (reference: hulc2_sim_data_module.py:115-126): the epoch ends
    with the shortest loader."""
    for batches in zip(*loaders):
        yield dict(zip(modalities, batches))


class PinnedRing:
    """``n_slots`` sets of pinned host buffers of the given (shape, dtype)
    specs, handed out in turn. A slot is handed out again only after the
    batch written into it was released with the event of its copy to the
    device and that event has completed, so a buffer is never rewritten
    while its copy may still read it. ``close`` makes every wait give up."""

    def __init__(self, specs: Dict[str, tuple], n_slots: int):
        def pinned(shape, dtype):
            t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=True)
            return t, t.numpy()

        self.slots = [{k: pinned(shape, dtype) for k, (shape, dtype) in specs.items()}
                      for _ in range(n_slots)]
        self._free = [threading.Event() for _ in range(n_slots)]
        for f in self._free:
            f.set()
        self._events: List[Optional[torch.cuda.Event]] = [None] * n_slots
        self._closed = threading.Event()

    def acquire(self, i: int, timeout: float = 600.0) -> Dict[str, np.ndarray]:
        """Numpy views of slot ``i``'s buffers, once its last copy is done."""
        deadline = time.monotonic() + timeout
        while not self._free[i].wait(0.1):
            if self._closed.is_set():
                raise RuntimeError("the pinned ring was closed")
            if time.monotonic() > deadline:
                raise RuntimeError(f"slot {i} of the pinned ring was not released in {timeout} s: "
                                   "its batches must go through DevicePrefetcher")
        self._free[i].clear()
        if self._events[i] is not None:
            self._events[i].synchronize()
        return {k: arr for k, (_, arr) in self.slots[i].items()}

    def batch(self, i: int) -> "PinnedBatch":
        return PinnedBatch({k: t for k, (t, _) in self.slots[i].items()}, self, i)

    def release(self, i: int, event: Optional[torch.cuda.Event]) -> None:
        self._events[i] = event
        self._free[i].set()

    def close(self) -> None:
        self._closed.set()


class PinnedBatch(dict):
    """A batch of pinned tensors in a slot of a ``PinnedRing``; ``release``
    hands the slot back with the event that follows the batch's copy."""

    def __init__(self, tensors: Dict[str, torch.Tensor], ring: PinnedRing, slot: int):
        super().__init__(tensors)
        self.ring, self.slot = ring, slot

    def release(self, event: Optional[torch.cuda.Event]) -> None:
        self.ring.release(self.slot, event)


class FusedBatchLoader:
    """Single-pass fused-batch assembly on the host (``hulc2_tpu/data/loader.py:103-229``):
    [vis; lang] rows in one write per byte.

    Each batch's final buffers are allocated once per batch (or taken from a
    pinned ring) and each worker thread writes its sample's padded window
    straight into its row (``WindowDataset.write_into``): the vis rows first,
    then the lang rows in the keys both modalities have, and ``lang``,
    ``use_for_aux_lang_loss`` and ``lang_task_id`` for the lang rows only.
    Epoch ``e`` takes its orders from ``default_rng((seed, e + 1, 0|1))`` and
    its window sizes from ``(dataset seed, e, idx)``, as the JAX loader does.
    An inner pool fills one batch's rows, a pool of two assembles the next
    two batches meanwhile. Without ``pin_memory`` batches are dicts of numpy
    arrays; with it, ``PinnedBatch`` dicts of pinned tensors from a ring of
    ``RING_SLOTS`` slots, which ``DevicePrefetcher`` copies to the card and
    releases. In a data-parallel run each process takes its
    ``process_shard`` of both orders (``hulc2_tpu/data/loader.py:157-167``)."""

    LOOKAHEAD = 2
    RING_SLOTS = LOOKAHEAD + 1  # the batches assembled ahead and the one being copied

    def __init__(self, vis_dataset: WindowDataset, lang_dataset: WindowDataset,
                 batch_size_vis: int, batch_size_lang: int, seed: int = 0,
                 num_threads: int = 4, pin_memory: bool = False, process_index: int = 0,
                 process_count: int = 1):
        self.vis = vis_dataset
        self.lang = lang_dataset
        self.bv = batch_size_vis
        self.bl = batch_size_lang
        self.seed = seed
        # the copies are CPU-bound: threads beyond the core count only contend
        self.num_threads = max(1, min(num_threads, os.cpu_count() or num_threads))
        self.pin_memory = pin_memory
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        vis_specs = vis_dataset.out_specs(batch_size_vis + batch_size_lang)
        lang_specs = lang_dataset.out_specs(batch_size_vis + batch_size_lang)
        self.specs = dict(vis_specs)
        self._lang_only = [k for k in lang_specs if k not in vis_specs]
        for k in self._lang_only:
            shape, dtype = lang_specs[k]
            self.specs[k] = ((batch_size_lang, *shape[1:]), dtype)

    def __len__(self) -> int:
        return min(len(self.vis) // self.process_count // self.bv,
                   len(self.lang) // self.process_count // self.bl)

    def _orders(self, epoch: int):
        return fused_orders(self.seed, epoch, len(self.vis), len(self.lang), self.process_index,
                            self.process_count)

    def _fill(self, pool, out: Dict[str, np.ndarray], vis_idxs, lang_idxs, epoch: int) -> None:
        # the lang rows follow the vis rows in the shared keys; the lang-only
        # keys are indexed from 0
        lang_out = {k: (v if k in self._lang_only else v[self.bv:]) for k, v in out.items()}
        jobs = ([(self.vis, out, row, idx) for row, idx in enumerate(vis_idxs)]
                + [(self.lang, lang_out, row, idx) for row, idx in enumerate(lang_idxs)])

        def fill(job):
            ds, dst, row, idx = job
            ds.write_into(int(idx), dst, row, epoch)

        if pool is None:
            for job in jobs:
                fill(job)
        else:
            list(pool.map(fill, jobs))

    def _ring(self):
        """Where batch b is written: slot ``b % RING_SLOTS`` of a ring (an
        object with ``acquire``, ``batch`` and ``close``, as ``PinnedRing``),
        or None for fresh arrays per batch."""
        return PinnedRing(self.specs, self.RING_SLOTS) if self.pin_memory else None

    def _assemble(self, pool, ring: Optional[PinnedRing], b: int, vis_idxs, lang_idxs, epoch: int):
        if ring is None:
            out = {k: np.empty(shape, dtype) for k, (shape, dtype) in self.specs.items()}
            self._fill(pool, out, vis_idxs, lang_idxs, epoch)
            return out
        slot = b % self.RING_SLOTS
        self._fill(pool, ring.acquire(slot), vis_idxs, lang_idxs, epoch)
        return ring.batch(slot)

    def __iter__(self) -> Iterator[Dict]:
        epoch = self.epoch
        self.epoch += 1
        # the JAX loader draws the epoch's order after advancing the counter
        ov, ol = self._orders(self.epoch)
        nb = len(self)
        ring = self._ring()

        def idxs(b):
            return ov[b * self.bv:(b + 1) * self.bv], ol[b * self.bl:(b + 1) * self.bl]

        if self.num_threads <= 1:
            try:
                for b in range(nb):
                    yield self._assemble(None, ring, b, *idxs(b), epoch)
            finally:
                if ring is not None:
                    ring.close()
            return
        pool = ThreadPoolExecutor(max_workers=self.num_threads)
        outer = ThreadPoolExecutor(max_workers=self.LOOKAHEAD)
        try:
            pending = deque(outer.submit(self._assemble, pool, ring, b, *idxs(b), epoch)
                            for b in range(min(self.LOOKAHEAD, nb)))
            for b_next in range(len(pending), nb + len(pending)):
                batch = pending.popleft().result()
                if b_next < nb:
                    pending.append(outer.submit(self._assemble, pool, ring, b_next,
                                                *idxs(b_next), epoch))
                yield batch
        finally:
            if ring is not None:
                ring.close()
            outer.shutdown(wait=False, cancel_futures=True)
            pool.shutdown(wait=False, cancel_futures=True)


def to_device(batch: Dict, device: torch.device) -> Dict:
    """A (nested) dict of numpy arrays and tensors on ``device``. Host arrays
    go to the card through pinned memory without waiting (a tensor that is
    pinned already is not copied into pinned memory again); tensors already
    on a device of ``device``'s type pass through (``cuda`` and ``cuda:0``
    are one device here)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = to_device(v, device)
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if t.device.type == "cpu" and device.type == "cuda":
            if not t.is_pinned():
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        elif t.device.type != device.type:
            t = t.to(device)
        out[k] = t
    return out


def tensors(batch: Dict) -> Iterator[torch.Tensor]:
    """The tensors of a (nested) batch dict."""
    for v in batch.values():
        if isinstance(v, dict):
            yield from tensors(v)
        else:
            yield v


class DevicePrefetcher:
    """A thread that runs ``iterator`` ``prefetch`` batches ahead of the
    consumer and puts each batch on ``device`` (``to_device``).

    On the card the thread enqueues its work on a side stream and records an
    event after each batch; ``__next__`` makes the consumer's current stream
    wait on that event and marks the batch's tensors as used by that stream,
    so the allocator does not hand their memory out while the step may still
    read it. A ``PinnedBatch`` is released with that event, the one that
    follows its copy. ``wait_s`` sums the seconds the consumer spent blocked
    on the queue. ``close`` also closes the stream (the loader's generator),
    so that its worker threads stop."""

    def __init__(self, iterator, device, prefetch: int = 2):
        self.device = torch.device(device)
        self.it = iter(iterator)
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.wait_s = 0.0
        self._done = object()
        self._stopped = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless stopped; False once stopped."""
        while not self._stopped.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        ctx = torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()
        try:
            with ctx:
                for host in self.it:
                    if self._stopped.is_set():
                        return
                    batch = to_device(host, self.device)
                    event = None
                    if self.stream is not None:
                        event = torch.cuda.Event()
                        event.record(self.stream)
                    if isinstance(host, PinnedBatch):
                        host.release(event)
                    if not self._put((batch, event)):
                        return
        except BaseException as e:  # handed to the consumer, which raises it
            self._put(e)
            return
        self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        item = self.q.get()
        self.wait_s += time.perf_counter() - t0
        if item is self._done:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors(batch):
                t.record_stream(stream)
        return batch

    def close(self, timeout: float = 60.0) -> None:
        """Stop the thread (an early end of the epoch): mark it stopped, drain
        the queue so that it is not blocked on a put, and join it."""
        self._stopped.set()
        while self.thread.is_alive():
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.1)
            timeout -= 0.1
            if timeout <= 0:
                raise RuntimeError("the prefetch thread did not stop")
        close = getattr(self.it, "close", None)
        if close is not None:
            close()
