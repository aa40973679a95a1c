"""Batch loading: threaded window assembly and the device prefetcher
(``hulc2_tpu/data/loader.py``).

``BatchLoader`` (with ``collate`` and ``zip_modalities``) yields the
validation split's {"vis": ..., "lang": ...} numpy batches.
``DevicePrefetcher`` runs a training batch stream in a thread: on the card it
makes the stream's device work (the device store's gather) and the copies of
its host arrays on a side stream, from pinned memory without waiting, and the
consumer's stream waits on an event before it reads the batch. The host
``FusedBatchLoader`` and the subprocess loader (the path without the device
store) are not ported.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from hulc2_torch.data.window_dataset import WindowDataset


def collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchLoader:
    """Epoch-based batch iterator over a WindowDataset, shuffled or in index
    order; the last partial batch is dropped."""

    def __init__(self, dataset: WindowDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_threads: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(n) if self.shuffle else np.arange(n)

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


def zip_modalities(modalities, *loaders) -> Iterator[Dict[str, Dict]]:
    """Zip per-modality loaders per step the way Lightning zips the dict of
    DataLoaders (reference: hulc2_sim_data_module.py:115-126): the epoch ends
    with the shortest loader."""
    for batches in zip(*loaders):
        yield dict(zip(modalities, batches))


def to_device(batch: Dict, device: torch.device) -> Dict:
    """A (nested) dict of numpy arrays and tensors on ``device``. Host arrays
    go to the card through pinned memory without waiting; tensors already on
    a device of ``device``'s type pass through (``cuda`` and ``cuda:0`` are
    one device here)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = to_device(v, device)
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if t.device.type == "cpu" and device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        elif t.device.type != device.type:
            t = t.to(device)
        out[k] = t
    return out


class DevicePrefetcher:
    """A thread that runs ``iterator`` ``prefetch`` batches ahead of the
    consumer and puts each batch on ``device`` (``to_device``).

    On the card the thread enqueues its work on a side stream and records an
    event after each batch; ``__next__`` makes the consumer's current stream
    wait on that event and marks the batch's tensors as used by that stream,
    so the allocator does not hand their memory out while the step may still
    read it. ``wait_s`` sums the seconds the consumer spent blocked on the
    queue."""

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
                for batch in self.it:
                    if self._stopped.is_set():
                        return
                    batch = to_device(batch, self.device)
                    event = None
                    if self.stream is not None:
                        event = torch.cuda.Event()
                        event.record(self.stream)
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
            for t in batch.values():
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
