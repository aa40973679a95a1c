"""The program's own spans and counters (``hulc2_torch.core.trace``) in a
slice of steps after the window, reduced to what the per-layer readers
take (``layers["program"]``).

The slice has two parts, as ``tools/profile_train`` profiles a step:

- ``replayed``: steps as the window runs them (on the card, replays of the
  step's CUDA graph), fed by the prefetch thread, with the tracer on and no
  profiler. Each span's calls and host ms a step; the prefetch thread's
  spans (``prefetch.produce`` > ``store.plan_rows``, ``store.gather``,
  ``prefetch.to_device``, ``prefetch.put``) among them.
- ``eager``: as many steps more, eager (the step's ``eager=True``), with the
  tracer on and device activity profiled, on batches taken before it with
  the prefetch thread then stopped, so that every launch is the step's.
  Each span's calls, host ms and device ms a step: the union of the device
  activities whose runtime launch falls inside one of the span's intervals,
  the spans placed on the trace's clock by the epoch clock (``to_trace_us``,
  as ``tools/profile_train`` places them). A replayed step has no inner
  spans; these are the phases' device times.

Both parts give the tracer's counters a step. Spans are kept whole: one
that ends after its part's last step, and one that opened inside a span
that the part did not record (at the top where its name elsewhere has a
parent), are left out with what they hold. A program without the tracer
gives no slice."""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness.trace import union_us

# the ``cuda*`` and ``cu*`` calls that put work on the card (``tools/profile_train.LAUNCH``)
LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")


def whole(spans: Sequence, end_ns: Optional[int] = None) -> list:
    """The spans kept whole (see the module's docstring)."""
    by_id = {s.id: s for s in spans}
    nested = {s.name for s in spans if s.parent}
    ok: Dict[int, bool] = {}

    def keep(s) -> bool:
        if s.id not in ok:
            if end_ns is not None and s.end_ns > end_ns:
                ok[s.id] = False
            elif s.parent == 0:
                ok[s.id] = s.name not in nested
            else:
                ok[s.id] = s.parent in by_id and keep(by_id[s.parent])
        return ok[s.id]

    return [s for s in spans if keep(s)]


def table(spans: Sequence, steps: int) -> Dict[str, dict]:
    """{name: {"calls", "host_ms"}} a step."""
    rows: Dict[str, dict] = defaultdict(lambda: {"calls": 0.0, "host_ms": 0.0})
    for s in spans:
        rows[s.name]["calls"] += 1 / steps
        rows[s.name]["host_ms"] += (s.end_ns - s.start_ns) / 1e6 / steps
    return dict(rows)


def to_trace_us(t_ns: int, clock: Tuple[int, int], trace_start_ns: int) -> float:
    """A host ``perf_counter_ns`` on the trace's clock (us from its start),
    by the epoch clock: ``time.time_ns`` read with ``perf_counter_ns``
    (``clock``), against the trace's start on the epoch clock
    (``tools/profile_train.to_trace_us``, copied)."""
    wall, perf = clock
    return (wall + t_ns - perf - trace_start_ns) / 1e3


def device_ms(spans: Sequence, launches: Dict[int, float],
              device: List[Tuple[int, float, float]], steps: int,
              place: Callable[[int], float]) -> Dict[str, float]:
    """{span name: device ms a step}: the union of the device activities
    (``device``: correlation id, start us, end us) whose launch (``launches``:
    correlation id -> start us) falls inside one of the span's intervals,
    placed by ``place``."""
    by_name: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for s in spans:
        by_name[s.name].append((place(s.start_ns), place(s.end_ns)))
    out = {}
    for name, intervals in by_name.items():
        intervals.sort()
        starts = [a for a, _ in intervals]
        inside = []
        for corr, a, b in device:
            t = launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= intervals[i][1]:
                inside.append((a, b))
        out[name] = union_us(inside) / 1e3 / steps
    return out


def _per_step(counters: Dict[str, int], steps: int) -> Dict[str, float]:
    return {k: v / steps for k, v in sorted(counters.items())}


def program_slice(next_batch: Callable[[], dict], close_feed: Callable[[], None],
                  run_step: Callable[[dict, bool], object], steps: int, device) -> Optional[dict]:
    """{"replayed", "eager"} of ``steps`` steps each (see the module's
    docstring); ``run_step(batch, eager)`` seeds and runs one step;
    ``close_feed`` stops the prefetch thread. None without the tracer."""
    try:
        from hulc2_torch.core import trace
    except ImportError:
        return None

    trace.drain()
    trace.enable()
    try:
        for _ in range(steps):
            run_step(next_batch(), False)
        torch.cuda.synchronize(device)
        end_ns = time.perf_counter_ns()
    finally:
        trace.disable()
    held = [next_batch() for _ in range(steps)]
    close_feed()
    drained = trace.drain()
    replayed = {"steps": steps, "spans": table(whole(drained["spans"], end_ns), steps),
                "counters": _per_step(drained["counters"], steps)}

    torch.cuda.synchronize(device)
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(device)
            clock = (time.time_ns(), time.perf_counter_ns())
            t0 = time.perf_counter_ns()
            for raw in held:
                run_step(raw, True)
            torch.cuda.synchronize(device)
            t1 = time.perf_counter_ns()
    finally:
        trace.disable()
    drained = trace.drain()
    del held
    events = prof.events()
    device_events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation]
    launches = {e.id: e.time_range.start for e in events
                if e.device_type == torch.autograd.DeviceType.CPU and LAUNCH.match(e.name)}
    device = [(e.id, e.time_range.start, e.time_range.end) for e in device_events]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    spans = whole(drained["spans"])
    rows = table(spans, steps)
    for name, ms in device_ms(spans, launches, device, steps,
                              lambda t: to_trace_us(t, clock, start_ns)).items():
        rows[name]["device_ms"] = ms
    joined = [(a, b) for corr, a, b in device if corr in launches]
    all_us = union_us([(a, b) for _, a, b in device])
    eager = {"steps": steps, "spans": rows, "counters": _per_step(drained["counters"], steps),
             "ms_per_step": (t1 - t0) / 1e6 / steps, "busy_ms": all_us / 1e3 / steps,
             "joined_share": union_us(joined) / all_us if all_us else None}
    return {"replayed": replayed, "eager": eager}


def summary(program: dict) -> dict:
    """The slice in short, for the run's diagnostics: each part's rows and
    figures to four digits."""
    def short(v):
        if isinstance(v, dict):
            return {k: short(x) for k, x in v.items()}
        return float(f"{v:.4g}") if isinstance(v, float) else v

    return short(program)


def span_row(rec: dict, part: str, name: str) -> Optional[dict]:
    """The row of span ``name`` in the program slice's ``part``, or None."""
    program = rec.get("layers", {}).get("program") or {}
    return (program.get(part) or {}).get("spans", {}).get(name)
