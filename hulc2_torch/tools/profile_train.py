"""Where the time of a policy train step goes, on the card.

    python -m hulc2_torch.tools.profile_train [--config-name cfg_low_level] [--steps 5]
        [--warmup 5] [--trace OUT.json] [--data DATASET] [key=value ...]

Takes ``--warmup`` steps, times ``--steps`` more on the host clock (each
ending in a device synchronise), then runs ``--steps`` steps under
``torch.profiler`` and prints, per step: the wall time without and with the
profiler, the device-busy time (union of the kernels' intervals), the idle
share (the rest of the unprofiled wall time), the count of kernels and
copies, the device time by kernel family and the top kernels. These are the
steps as they run: on the card, replays of the step's CUDA graph once the
warm-up has captured it. ``--trace`` then profiles ``--steps`` more steps
with each op's shapes recorded and the tracer on (the program's spans in the
trace, their cost in the wall time) and writes their Chrome trace; those
steps run eager (the step's ``eager=True``), because ``roofline`` links each
kernel to the op that launched it, which a replayed kernel does not have.
Then one slice of ``--steps`` steps back to back with the tracer on,
device activity profiled (``traced_slice``), and its table per span
(``phase_table``): its calls, host ms, runtime launches and device idle ms
a step (the prefetch thread's spans apart from the step's thread), the
counters (``train.host_syncs``, ``train.device_mallocs``,
``prefetch.pinned_allocs``, and the step's graph: ``train.eager_steps``,
``train.graph_captures``, ``train.graph_replays``, those of the warm-up
too, which runs with the tracer on) and the prefetch thread's batches
joined to the step's. A slice of replayed steps is labelled "(replayed)":
its steps have the span ``train.replay`` and no inner phases. Counterpart of
``hulc2_tpu/tools/profile_train.py``; ``--config-name`` and the overrides
are those of ``hulc2_torch.training`` (the flagship without
``--config-name``).

The steps train on synthetic windows made on the card beforehand, or with
``--data`` on the dataset there as ``python -m hulc2_torch.training`` does:
the training split's frames resident on the card, each step's batch from
the device-store loader through the prefetch thread. A step from disk then
includes its wait for the batch, and its device time includes the store's
gather and the copies of the small keys. The store is the dataset's own
size: figures for a store at a real dataset's size come from the
benchmark's cell (``python3 portbench/run.py --workload
flagship.train.store --seed 0 --seconds 30 --trace 1``). A config without
the device store (``cfg_low_level``) trains from the host loader
(``FusedBatchLoader``: npz files, native reads, pinned ring); then the
loader alone is timed first, ``--steps`` batches through the prefetch
thread to the card with no step, which is the most batches per second the
host can feed.
"""
from __future__ import annotations

import argparse
import bisect
import itertools
import re
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from hulc2_torch.configs.flagship import flagship_config
from hulc2_torch.core import trace
from hulc2_torch.core.config import compose, options
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.loader import DevicePrefetcher, FusedBatchLoader
from hulc2_torch.tools import profiling
from hulc2_torch.train.trainer import Trainer
from hulc2_torch.training import SyntheticRun

PREFETCH = 2  # batches the prefetch thread holds on the device ahead of the step


class DiskRun:
    """The trainer's train step on the dataset at ``datamodule.root_data_dir``;
    ``next_batch()`` is None and ``step(None)`` takes the next batch from the
    prefetcher, epoch after epoch, waiting for it if it is not ready (the
    span ``prefetch.next`` while tracing). ``store`` is None on the host
    loader's path."""

    def __init__(self, cfg: dict, device="cuda"):
        dm = Hulc2DataModule(cfg["datamodule"], seed=cfg["seed"], device=device)
        dm.setup()
        trainer = Trainer(cfg, dm, run_dir=None, device=dm.device)
        self.device = trainer.device
        self.train_step = trainer.make_train_step()
        self.generator = trainer.generator
        self.kl_beta = cfg["loss"]["kl_beta"]
        self.loader = dm.fused_train_iter()
        self.store = dm.device_store
        self.batches = self._endless()

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

    def step(self, _, eager: bool = False) -> Dict[str, torch.Tensor]:
        return self.train_step(next(self.batches), self.generator, self.kl_beta, eager=eager)


# ---- the program's spans on the device trace's clock ---------------------- #
# runtime calls that put work on the card
LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset)")
NO_SPAN = "no program span"
PHASES = ("train.forward", "train.backward", "train.optimizer")
GRAPH_COUNTERS = ("train.eager_steps", "train.graph_captures", "train.graph_replays")


def traced_slice(run, n: int) -> dict:
    """``n`` steps of ``run`` back to back under ``torch.profiler``
    recording device activity only (so the host runs at nearly its own
    pace), with the tracer (``core/trace``) on: {"ms_per_step" (host clock,
    the slice's steps through its closing synchronise), "steps", "device"
    [(start, end) us], "launches" [start us], "clock" (``time.time_ns`` and
    ``time.perf_counter_ns`` read together), "trace_start_ns" (the trace's
    start on the epoch clock), "spans", "counters"}. Times in us are on the
    trace's clock; its ``launches`` are the runtime's kernel launches,
    copies and memsets, of every thread (the profiler numbers threads its
    own way)."""
    batches = [run.next_batch() for _ in range(n)]
    device = run.device
    trace.drain()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(device)
            clock = (time.time_ns(), time.perf_counter_ns())
            t0 = time.perf_counter_ns()
            for raw in batches:
                run.step(raw)
            torch.cuda.synchronize(device)
            t_end = time.perf_counter_ns()
    finally:
        trace.disable()
    drained = trace.drain()
    return {"ms_per_step": (t_end - t0) / 1e6 / n, "steps": n,
            "device": [(e.time_range.start, e.time_range.end)
                       for e in profiling.device_activities(prof)],
            "launches": [e.time_range.start for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CPU
                         and LAUNCH.match(e.name)],
            "clock": clock, "trace_start_ns": prof.profiler.kineto_results.trace_start_ns(),
            **drained}


def to_trace_us(t_ns: int, sl: dict) -> float:
    """A host ``perf_counter_ns`` of the slice ``sl`` on its trace's clock
    (us from the trace's start), by the epoch clock: ``time.time_ns`` read
    with ``perf_counter_ns``, against the trace's start on the epoch clock."""
    wall, perf = sl["clock"]
    return (wall + t_ns - perf - sl["trace_start_ns"]) / 1e3


class Innermost:
    """The innermost of one thread's spans open at a time on the trace's
    clock: of the spans open then, the one that started last."""

    def __init__(self, spans: list, times: Dict[int, Tuple[float, float]]):
        self.spans = sorted(spans, key=lambda s: times[s.id][0])
        self.starts = [times[s.id][0] for s in self.spans]
        self.ends = [times[s.id][1] for s in self.spans]
        self.reach = list(itertools.accumulate(self.ends, max))  # the latest end so far

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] > t:
            if self.ends[i] > t:
                return self.spans[i]
            i -= 1
        return None


def phase_table(sl: dict) -> dict:
    """The slice's spans per name: {"rows": {name: {"thread": "main" or
    "worker", "calls", "host_ms", "launches", "idle_ms"}}, "idle_ms"}, each
    per step, the spans placed on the trace's clock by ``to_trace_us``.
    ``host_ms`` sums the spans' durations. Each idle gap of the device
    (between the union of its activities) goes to the innermost main-thread
    span open at the gap's start and to each span around it, and so does
    each runtime launch, by its start: the profiler does not tell the
    prefetch thread's launches (the store's gather and the small keys'
    copies, ~10 a batch) apart, and they count where they fall. What no span
    holds goes to ``no program span``. The main thread is the one that ran
    ``train.step``."""
    spans, n = sl["spans"], sl["steps"]
    times = {s.id: (to_trace_us(s.start_ns, sl), to_trace_us(s.end_ns, sl)) for s in spans}
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "train.step"]
    main = steps[0].thread if steps else None
    inner = Innermost([s for s in spans if s.thread == main], times)
    rows: Dict[str, dict] = {}

    def row(name: str, thread) -> dict:
        return rows.setdefault(name, {"thread": "main" if thread == main else "worker",
                                      "calls": 0.0, "host_ms": 0.0, "launches": 0.0,
                                      "idle_ms": 0.0})

    def charge(t: float, key: str, value: float) -> None:
        s = inner.at(t)
        if s is None:
            row(NO_SPAN, main)[key] += value / n
        while s is not None:
            row(s.name, s.thread)[key] += value / n
            s = by_id.get(s.parent)

    for s in spans:
        r = row(s.name, s.thread)
        r["calls"] += 1 / n
        r["host_ms"] += (s.end_ns - s.start_ns) / 1e6 / n
    idle_us, end = 0.0, None
    for a, b in sorted(sl["device"]):
        if end is not None and a > end:
            idle_us += a - end
            charge(end, "idle_ms", (a - end) / 1e3)
        end = b if end is None else max(end, b)
    for t in sl["launches"]:
        charge(t, "launches", 1.0)
    return {"rows": rows, "idle_ms": idle_us / 1e3 / n}


def _overlap_ns(a: Tuple[int, int], intervals: List[Tuple[int, int]]) -> int:
    return sum(max(0, min(a[1], e) - max(a[0], b)) for b, e in intervals)


def handoffs(spans: list) -> dict:
    """The prefetch thread's batches joined to the step's: {"batches" (both
    threads name it: ``prefetch.produce`` and ``prefetch.next`` by their
    prefetcher and batch number), "lead_ms" (the mean time a batch waited in
    the queue before the step asked for it; negative: the step waited for
    it), "overlap" (the share of the producer's time spent while the main
    thread was inside ``train.step``), "next_overlap" (the share of the
    consumer's ``prefetch.next`` time in which the producer was at work, in
    ``prefetch.produce`` and not blocked in ``prefetch.put``)}. The end of a
    prefetcher's stream counts as a batch: the consumer's last
    ``prefetch.next`` waits for the producer's last next."""
    def key(s):
        return s.attrs.get("prefetcher"), s.attrs.get("batch")

    made = {key(s): s for s in spans if s.name == "prefetch.produce"}
    taken = {key(s): s for s in spans if s.name == "prefetch.next"}
    joined = [k for k in taken if k in made]
    steps = [(s.start_ns, s.end_ns) for s in spans if s.name == "train.step"]
    blocked = {s.parent: (s.start_ns, s.end_ns) for s in spans if s.name == "prefetch.put"}
    working = []
    for p in made.values():
        b = blocked.get(p.id, (p.end_ns, p.end_ns))
        working += [(p.start_ns, b[0]), (b[1], p.end_ns)]
    produced = sum(made[k].end_ns - made[k].start_ns for k in joined)
    waited = sum(taken[k].end_ns - taken[k].start_ns for k in joined)
    leads = [(taken[k].start_ns - made[k].end_ns) / 1e6 for k in joined]
    return {"batches": len(joined), "lead_ms": statistics.fmean(leads) if leads else None,
            "overlap": (sum(_overlap_ns((made[k].start_ns, made[k].end_ns), steps)
                            for k in joined) / produced if produced else None),
            "next_overlap": (sum(_overlap_ns((taken[k].start_ns, taken[k].end_ns), working)
                                 for k in joined) / waited if waited else None)}


def print_phases(on: dict, warmup: Optional[dict] = None) -> None:
    """The per-phase table of the traced slice ``on`` and its counters, and
    the step's graph counters of the warm-up's counters ``warmup``."""
    table = phase_table(on)
    n = on["steps"]
    rows = table["rows"]
    replayed = on["counters"].get("train.graph_replays", 0) == n
    print(f"per phase, per step ({n} steps traced back to back, device activity profiled; "
          f"host clock){' (replayed)' if replayed else ''}: {on['ms_per_step']:.2f} ms a step, "
          f"the tracer's cost in it")
    print(f"  {'span':<22} {'thread':<6} {'calls':>6} {'host ms':>9} {'launches':>9} "
          f"{'idle ms':>8}")
    for name, r in sorted(rows.items(), key=lambda kv: (kv[1]["thread"], -kv[1]["host_ms"])):
        print(f"  {name:<22} {r['thread']:<6} {r['calls']:6.2f} {r['host_ms']:9.3f} "
              f"{r['launches']:9.1f} {r['idle_ms']:8.3f}")
    step = rows.get("train.step", {}).get("host_ms")
    if step and not replayed:
        parts = sum(rows.get(p, {}).get("host_ms", 0.0) for p in PHASES)
        print(f"  forward + backward + optimizer: {parts:.3f} ms, {100 * parts / step:.1f}% of "
              f"train.step")
    idle = table["idle_ms"]
    under = idle - rows.get(NO_SPAN, {}).get("idle_ms", 0.0)
    print(f"  device idle {idle:.3f} ms a step, {100 * under / idle if idle else 0:.1f}% of it "
          f"under a program span; {len(on['launches']) / n:.1f} runtime launches and "
          f"{len(on['device']) / n:.1f} device activities a step")
    counters = {k: v / n for k, v in sorted(on["counters"].items())}
    print(f"  counters a step: {counters}")
    graph = {k: on["counters"].get(k, 0) for k in GRAPH_COUNTERS}
    print(f"  the step's graph in the slice: {graph}" + (
        "" if warmup is None else
        f"; in the warm-up: { {k: warmup.get(k, 0) for k in GRAPH_COUNTERS} }"))
    h = handoffs(on["spans"])
    if h["batches"]:
        print(f"  prefetch: {h['batches']} batches joined; each waited {h['lead_ms']:.3f} ms in "
              f"the queue (mean); {100 * h['overlap']:.1f}% of the producer's time inside "
              f"train.step; the producer at work in {100 * h['next_overlap']:.1f}% of "
              f"prefetch.next")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Prints the breakdown; returns {"execs": the profiled steps' device
    activities a step by kernel family, "warmup": the warm-up's graph
    counters}."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--trace", default=None, help="write the Chrome trace here")
    parser.add_argument("--data", default=None,
                        help="train from this dataset (make_expert_dataset) through the device store")
    parser.add_argument("--config-name", default=None, choices=options("root"),
                        help="a root of the config registry (default: the flagship preset)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    overrides = list(args.overrides) + ([f"datamodule.root_data_dir={args.data}"] if args.data else [])
    cfg = (flagship_config(overrides) if args.config_name is None
           else compose(args.config_name, overrides))

    card = profiling.card_line()
    run = DiskRun(cfg) if args.data else SyntheticRun(cfg, device="cuda")
    host_loader = args.data is not None and run.store is None
    loader_ms = run.loader_ms(args.steps) if host_loader else None
    # on the host loader's path the batches assembled ahead during the
    # warm-up (the ring's slots and the prefetch queue) are used up first,
    # so that the timed steps wait for the loader as a long run does
    # the tracer counts the warm-up's eager steps and captures
    def timed(n: int) -> List[float]:
        return profiling.wall_ms(run.step, n, run.device, run.next_batch)

    trace.drain()
    trace.enable()
    try:
        timed(args.warmup + (FusedBatchLoader.RING_SLOTS + PREFETCH if host_loader else 0))
    finally:
        trace.disable()
    warmup = trace.drain()["counters"]
    plain_ms = statistics.median(timed(args.steps))

    prof, profiled_ms, kernels, busy_ms = profiling.profile_steps(run, args.steps)
    if args.trace:
        eager_prof, eager_ms, _, eager_busy_ms = profiling.profile_steps(run, args.steps,
                                                                         eager=True)
        eager_prof.export_chrome_trace(args.trace)

    b = profiling.breakdown(kernels, args.steps)

    source = "synthetic batches"
    if args.data:
        source = f"from {args.data} ({'device store' if run.store is not None else 'host loader'})"
    print(f"card: {card}; torch {torch.__version__}; config {args.config_name or 'flagship'}; {source}")
    print(f"wall per step: {plain_ms:.2f} ms (median of {args.steps}, no profiler), "
          f"{profiled_ms:.2f} ms under the profiler")
    if args.trace:
        print(f"eager steps of the trace for roofline ({args.trace}): {eager_ms:.2f} ms a step "
              f"under the profiler, the tracer on; device busy {eager_busy_ms:.2f} ms a step")
    if args.data and run.store is not None:
        print(f"device store: {run.store.nbytes} bytes resident in "
              f"{run.store.arrays[run.store.image_keys[0]].shape[0]} rows, uploaded in "
              f"{run.store.upload_s:.3f} s")
    if loader_ms is not None:
        batch_bytes = sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
                          for shape, dtype in run.loader.specs.values())
        print(f"host loader alone: {loader_ms:.2f} ms per batch of {batch_bytes} bytes "
              f"({batch_bytes / loader_ms / 1e6:.3f} GB/s to the card; {run.loader.num_threads} "
              f"threads, pinned ring of {run.loader.RING_SLOTS})")
    print(f"device busy per step: {busy_ms:.2f} ms; idle share {100 * (1 - busy_ms / plain_ms):.1f}% "
          f"of the unprofiled wall time ({100 * (1 - busy_ms / profiled_ms):.1f}% under the "
          f"profiler); {len(kernels) / args.steps:.0f} device activities (kernels, copies) per step")
    if args.data:
        # the store's gathers (index_select runs as a gather kernel), and any
        # other gather of the step
        print("gather and index_select kernels per step:")
        for name, times in sorted(b.by_name.items(), key=lambda kv: -sum(kv[1])):
            if re.search(r"gather|index_?select", name, re.IGNORECASE):
                print(f"  {sum(times) / 1e3 / args.steps:8.4f} ms  x{len(times) / args.steps:<5g} "
                      f"{name[:100]}")
    print("device time per step by kernel family:")
    print("\n".join(profiling.family_rows(b, busy_ms)))
    print("top kernels by device time per step:")
    print("\n".join(profiling.top_rows(b, args.steps, 15)))
    print_phases(traced_slice(run, args.steps), warmup)
    return {"execs": b.family_execs, "warmup": {k: warmup.get(k, 0) for k in GRAPH_COUNTERS}}


if __name__ == "__main__":
    main(sys.argv[1:])
