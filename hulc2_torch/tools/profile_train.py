"""Where the time of a policy train step goes, on the card.

    python -m hulc2_torch.tools.profile_train [--config-name cfg_low_level] [--steps 5]
        [--warmup 5] [--trace OUT.json] [--data DATASET [--store-rows N]] [key=value ...]

Takes ``--warmup`` steps, times ``--steps`` more on the host clock (each
ending in a device synchronise), then runs ``--steps`` steps under
``torch.profiler`` and prints, per step: the wall time without and with the
profiler, the device-busy time (union of the kernels' intervals), the idle
share (the rest of the unprofiled wall time), the count of kernels and
copies, the device time by kernel family and the top kernels. ``--trace``
writes the Chrome trace. Counterpart of ``hulc2_tpu/tools/profile_train.py``;
``--config-name`` and the overrides are those of ``hulc2_torch.training``
(the flagship without ``--config-name``).

The steps train on synthetic windows made on the card beforehand, or with
``--data`` on the dataset there as ``python -m hulc2_torch.training`` does:
the training split's frames resident on the card, each step's batch from
the device-store loader through the prefetch thread. A step from disk then
includes its wait for the batch, and its device time includes the store's
gather and the copies of the small keys. ``--store-rows N`` tiles the
training split's frames to N rows before the upload (263393 is the r5 expert
set's frame count) and sends each window's gather to a random copy of its
frames, so that a small dataset gives the store, its upload and its gathers
at a real dataset's size; the batches hold the same pixels. A config
without the device store (``cfg_low_level``) trains from the host loader
(``FusedBatchLoader``: npz files, native reads, pinned ring); then the
loader alone is timed first, ``--steps`` batches through the prefetch
thread to the card with no step, which is the most batches per second the
host can feed.
"""
from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.core.config import compose, options
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.loader import DevicePrefetcher, FusedBatchLoader
from hulc2_torch.train.trainer import Trainer
from hulc2_torch.training import SyntheticRun

# kernel name pattern -> family, first match wins
FAMILIES = [
    ("shift_normalize", r"shift_normalize"),
    ("optimizer", r"multi_tensor|adam|foreach"),
    ("conv (cuDNN)", r"conv|cudnn|fprop|dgrad|wgrad|implicit_gemm|winograd"),
    ("gemm (cuBLAS)", r"gemm|nvjet|cutlass|cublas|xmma|sm90_|gemv|splitK"),
    ("softmax", r"softmax"),
    ("reduction", r"reduce|norm"),
    ("index / copy", r"index|gather|scatter|copy|cat|Memcpy|Memset"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def family(name: str) -> str:
    for fam, pattern in FAMILIES:
        if re.search(pattern, name, re.IGNORECASE):
            return fam
    return "other"


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


PREFETCH = 2  # batches the prefetch thread holds on the device ahead of the step


class DiskRun:
    """The trainer's train step on the dataset at ``datamodule.root_data_dir``;
    ``next_batch()`` is None and ``step(None)`` takes the next batch from the
    prefetcher, epoch after epoch, waiting for it if it is not ready.
    ``wait_ms`` holds each step's wait. With ``store_rows`` the device store
    is tiled to that many rows (``tile_store``). ``store`` is None on the
    host loader's path."""

    def __init__(self, cfg: dict, device="cuda", store_rows: Optional[int] = None):
        dm = Hulc2DataModule(cfg["datamodule"], seed=cfg["seed"], device=device)
        dm.setup()
        copy_rows = tile_store(dm, store_rows) if store_rows else None
        trainer = Trainer(cfg, dm, run_dir=None, device=dm.device)
        self.device = trainer.device
        self.train_step = trainer.make_train_step()
        self.generator = trainer.generator
        self.kl_beta = cfg["loss"]["kl_beta"]
        self.loader = dm.fused_train_iter()
        self.store = dm.device_store
        if store_rows:
            self.store.gather = _spread_gather(self.store.gather, copy_rows, store_rows)
        self.batches = self._endless()
        self.wait_ms: List[float] = []

    def _endless(self):
        while True:
            it = DevicePrefetcher(self.loader, self.device, prefetch=PREFETCH)
            try:
                yield from it
            finally:
                it.close()

    def next_batch(self) -> None:
        return None

    def loader_ms(self, n: int) -> float:
        """Wall ms per batch of ``n`` batches through a fresh prefetch thread
        to the device, each synchronised, without a train step."""
        it = DevicePrefetcher(self.loader, self.device)
        try:
            next(it)  # the first batch carries the threads' start
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            for _ in range(n):
                next(it)
                torch.cuda.synchronize(self.device)
            return (time.perf_counter() - t0) * 1e3 / n
        finally:
            it.close()

    def step(self, _) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        raw = next(self.batches)
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        return self.train_step(raw, self.generator, self.kl_beta)


def tile_store(dm: Hulc2DataModule, rows: int) -> int:
    """Repeat the training split's image arrays in its RAM cache to ``rows``
    rows, before ``fused_train_iter`` uploads them; returns the rows of one
    copy. Frame ids keep mapping to the first copy."""
    ram = dm._stores["training"]
    keys = list(dm.cfg["observation_space"]["rgb_obs"])
    n = ram.arrays[keys[0]].shape[0]
    if rows < n:
        raise ValueError(f"--store-rows {rows} is below the dataset's {n} frames")
    for k in keys:
        ram.arrays[k] = np.resize(ram.arrays[k], (rows, *ram.arrays[k].shape[1:]))
    return n


def _spread_gather(gather, n: int, rows: int):
    """``gather`` with each window's frame rows moved to one of the
    ``rows // n`` whole copies of the frames, drawn at random per window."""
    rng = np.random.default_rng(0)

    def spread(frame_rows: np.ndarray):
        copy = rng.integers(0, rows // n, size=(frame_rows.shape[0], 1))
        return gather((frame_rows + n * copy).astype(np.int32))

    return spread


def _timed_steps(run, n: int) -> List[float]:
    times = []
    for _ in range(n):
        raw = run.next_batch()
        torch.cuda.synchronize(run.device)
        t0 = time.perf_counter()
        run.step(raw)
        torch.cuda.synchronize(run.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def profile_steps(run, n: int, record_shapes: bool = False) -> tuple:
    """``n`` steps of ``run`` under ``torch.profiler``, their batches made
    before it; returns (the profile, the wall ms per step under it, the
    device activities, the device-busy ms per step: the union of their
    intervals). ``record_shapes`` records each op's input shapes, which
    ``tools/roofline.py`` reads from the exported trace."""
    batches = [run.next_batch() for _ in range(n)]
    torch.cuda.synchronize(run.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        for raw in batches:
            run.step(raw)
        torch.cuda.synchronize(run.device)
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n
    # device activity: kernels, memcpys and memsets; not the device-side spans
    # of user annotations such as "Optimizer.step#Adam.step"
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / n
    return prof, profiled_ms, kernels, busy_ms


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--trace", default=None, help="write the Chrome trace here")
    parser.add_argument("--data", default=None,
                        help="train from this dataset (make_expert_dataset) through the device store")
    parser.add_argument("--store-rows", type=int, default=None,
                        help="with --data: tile the device store to this many frame rows")
    parser.add_argument("--config-name", default=None, choices=options("root"),
                        help="a root of the config registry (default: the flagship preset)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if args.store_rows and not args.data:
        parser.error("--store-rows needs --data")
    overrides = list(args.overrides) + ([f"datamodule.root_data_dir={args.data}"] if args.data else [])
    cfg = (flagship_config(overrides) if args.config_name is None
           else compose(args.config_name, overrides))
    if args.store_rows and not cfg["datamodule"]["device_store"]:
        parser.error("--store-rows tiles the device store: this config has none")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    run = DiskRun(cfg, store_rows=args.store_rows) if args.data else SyntheticRun(cfg, device="cuda")
    host_loader = args.data is not None and run.store is None
    loader_ms = run.loader_ms(args.steps) if host_loader else None
    # on the host loader's path the batches assembled ahead during the
    # warm-up (the ring's slots and the prefetch queue) are used up first,
    # so that the timed steps wait for the loader as a long run does
    _timed_steps(run, args.warmup + (FusedBatchLoader.RING_SLOTS + PREFETCH if host_loader else 0))
    plain_ms = statistics.median(_timed_steps(run, args.steps))
    wait_ms = statistics.median(run.wait_ms[-args.steps:]) if args.data else None

    prof, profiled_ms, kernels, busy_ms = profile_steps(run, args.steps, record_shapes=bool(args.trace))
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_name: Dict[str, List[float]] = defaultdict(list)
    for e in kernels:
        by_name[e.name].append(e.time_range.elapsed_us())
    by_family: Dict[str, float] = defaultdict(float)
    for name, times in by_name.items():
        by_family[family(name)] += sum(times) / 1e3 / args.steps

    source = "synthetic batches"
    if args.data:
        source = f"from {args.data} ({'device store' if run.store is not None else 'host loader'})"
    print(f"card: {card}; torch {torch.__version__}; config {args.config_name or 'flagship'}; {source}")
    print(f"wall per step: {plain_ms:.2f} ms (median of {args.steps}, no profiler), "
          f"{profiled_ms:.2f} ms under the profiler")
    if wait_ms is not None and run.store is not None:
        print(f"device store: {run.store.nbytes} bytes resident in "
              f"{run.store.arrays[run.store.image_keys[0]].shape[0]} rows, uploaded in "
              f"{run.store.upload_s:.3f} s")
    if loader_ms is not None:
        batch_bytes = sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
                          for shape, dtype in run.loader.specs.values())
        print(f"host loader alone: {loader_ms:.2f} ms per batch of {batch_bytes} bytes "
              f"({batch_bytes / loader_ms / 1e6:.3f} GB/s to the card; {run.loader.num_threads} "
              f"threads, pinned ring of {run.loader.RING_SLOTS})")
    if wait_ms is not None:
        print(f"wait for the prefetcher's batch: {wait_ms:.3f} ms per step (median, no profiler)")
    print(f"device busy per step: {busy_ms:.2f} ms; idle share {100 * (1 - busy_ms / plain_ms):.1f}% "
          f"of the unprofiled wall time ({100 * (1 - busy_ms / profiled_ms):.1f}% under the "
          f"profiler); {len(kernels) / args.steps:.0f} device activities (kernels, copies) per step")
    if args.data:
        # the store's gathers (index_select runs as a gather kernel), and any
        # other gather of the step
        print("gather and index_select kernels per step:")
        for name, times in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
            if re.search(r"gather|index_?select", name, re.IGNORECASE):
                print(f"  {sum(times) / 1e3 / args.steps:8.4f} ms  x{len(times) / args.steps:<5g} "
                      f"{name[:100]}")
    print("device time per step by kernel family:")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:<16} {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%")
    print("top kernels by device time per step:")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    for name, times in top:
        print(f"  {sum(times) / 1e3 / args.steps:8.3f} ms  x{len(times) // args.steps:<5d} {name[:100]}")


if __name__ == "__main__":
    main(sys.argv[1:])
