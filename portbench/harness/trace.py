"""Reading a ``torch.profiler`` slice of device activity only (kernels,
copies, memsets; not the device-side spans of annotations): busy time as the
union of their intervals (``tools/profile_train._union_us``, copied), the
device time by kernel name, and the idle gaps labelled by the benchmark's
own host spans, which it times on the host clock (``Spans``) and places on
the trace's clock by the slice's closing synchronise. The host side of the program is not
profiled, so the slice runs at nearly the window's pace."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile


def union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class Spans:
    """Named host intervals on ``time.perf_counter``."""

    def __init__(self):
        self.items: List[Tuple[float, float, str]] = []

    def span(self, name: str):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                spans.items.append((self.t0, time.perf_counter(), name))

        return _Span()


def profiler():
    return profile(activities=[ProfilerActivity.CUDA])


def read_slice(prof, t_end: float, wall_s: float, steps: int, spans: Spans) -> dict:
    """The slice reduced: {"busy_s", "window_s", "steps", "by_name" {kernel:
    (seconds, count)}, "breakdown"}. ``t_end`` is the host clock when the
    slice's closing synchronise returned, which the trace's last device
    activity's end is taken to meet. Raises when it saw no device activity."""
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    intervals = sorted((e.time_range.start, e.time_range.end) for e in device)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us() * 1e-6
        by_name[e.name][1] += 1
    last = max(b for _, b in intervals)
    host = sorted(((a - t_end) * 1e6 + last, (b - t_end) * 1e6 + last, n) for a, b, n in spans.items)
    gaps, end = [], intervals[0][1]
    for a, b in intervals[1:]:
        if a > end:
            gaps.append((a - end, end))
        end = max(end, b)
    labelled: Dict[str, float] = defaultdict(float)
    for length, at in gaps:
        label = next((n for s, e, n in host if s <= at < e), "other host work")
        labelled[label] += length * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "busy_s": union_us(intervals) * 1e-6, "window_s": wall_s, "steps": steps,
        "by_name": {k: tuple(v) for k, v in by_name.items()},
        "breakdown": {"device_ops": [[name[:120], v[0]] for name, v in top],
                      "idle_gaps": [[k, v] for k, v in sorted(labelled.items(),
                                                              key=lambda kv: -kv[1])[:10]]},
    }
