"""The port's measuring primitives, shared by the profilers and ``chip_smoke.py``.

- ``card_line``: the card's name and power limit, as ``nvidia-smi`` reads them;
- ``wall_ms``: host-clock ms of synchronised calls;
- ``profiled``: calls under ``torch.profiler``, their device activities and
  the device-busy ms per call (``union_us`` of the activities' intervals);
  ``profile_steps`` the same for the train steps of a run;
- ``breakdown``: a profile's activities by kernel name and by kernel family
  (``FAMILIES``, ``family``), with ``family_rows`` and ``top_rows`` to print
  them.
"""
from __future__ import annotations

import re
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from hulc2_torch.core import trace

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


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def card_line() -> str:
    """"name, power limit" of the first card, from ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wall_ms(fn: Callable, n: int, device=None, prepare: Optional[Callable] = None) -> List[float]:
    """Host-clock ms of each of ``n`` calls of ``fn()``, each preceded and
    followed by a synchronise of ``device`` (the current card by default).
    With ``prepare`` each call is ``fn(prepare())``, ``prepare()`` run
    before the first synchronise, off the clock."""
    times = []
    for _ in range(n):
        args = () if prepare is None else (prepare(),)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def device_activities(prof) -> list:
    """The profile's device activity: kernels, memcpys and memsets; not the
    device-side spans of user annotations such as "Optimizer.step#Adam.step".
    Raises when the card ran nothing."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    return events


class Profiled(NamedTuple):
    prof: object  # the ``torch.profiler.profile``
    activities: list  # ``device_activities(prof)``
    busy_ms: float  # device-busy ms per call: the union of the activities' intervals
    wall_ms: float  # host-clock ms per call under the profiler, through its closing synchronise


def profiled(fn: Callable, n: int, record_shapes: bool = False) -> Profiled:
    """``n`` calls of ``fn()`` under ``torch.profiler`` (host and device
    activity; each op's input shapes with ``record_shapes``), after a
    synchronise and up to one inside the profile."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    activities = device_activities(prof)
    busy = union_us([(e.time_range.start, e.time_range.end) for e in activities]) / 1e3 / n
    return Profiled(prof, activities, busy, wall)


def profile_steps(run, n: int, eager: bool = False) -> tuple:
    """``n`` steps of ``run`` under ``torch.profiler``, their batches made
    before it; returns (the profile, the wall ms per step under it, the
    device activities, the device-busy ms per step: the union of their
    intervals). With ``eager`` the steps run eager, each op's input shapes
    are recorded and the tracer (``core/trace``) is on, so that the
    program's spans are in the trace: each kernel has the op that launched
    it, and the hand-written kernel's launch span carries its shape, which
    ``tools/roofline.py`` reads from the exported trace; the wall time then
    holds the tracer's cost."""
    batches = iter([run.next_batch() for _ in range(n)])
    if eager:
        trace.enable()
    try:
        p = profiled(lambda: run.step(next(batches), eager=eager), n, record_shapes=eager)
    finally:
        if eager:
            trace.disable()
            trace.drain()
    return p.prof, p.wall_ms, p.activities, p.busy_ms


class Breakdown(NamedTuple):
    by_name: Dict[str, List[float]]  # kernel name -> the us of each of its executions
    family_ms: Dict[str, float]  # family -> device ms per call, largest first
    family_execs: Dict[str, float]  # family -> executions per call


def breakdown(activities: list, n: int) -> Breakdown:
    """The device activities of ``n`` calls by kernel name and by family."""
    by_name: Dict[str, List[float]] = defaultdict(list)
    for e in activities:
        by_name[e.name].append(e.time_range.elapsed_us())
    family_ms: Dict[str, float] = defaultdict(float)
    family_execs: Dict[str, float] = defaultdict(float)
    for name, times in by_name.items():
        family_ms[family(name)] += sum(times) / 1e3 / n
        family_execs[family(name)] += len(times) / n
    return Breakdown(dict(by_name), dict(sorted(family_ms.items(), key=lambda kv: -kv[1])),
                     dict(family_execs))


def family_rows(b: Breakdown, busy_ms: float) -> List[str]:
    """One line per family: device ms per call and share of ``busy_ms``."""
    return [f"  {fam:<16} {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%"
            for fam, ms in b.family_ms.items()]


def top_rows(b: Breakdown, n: int, top: int) -> List[str]:
    """The ``top`` kernels by device time: ms and executions per call, name."""
    ranked = sorted(b.by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    return [f"  {sum(times) / 1e3 / n:8.3f} ms  x{len(times) // n:<5d} {name[:100]}"
            for name, times in ranked]
