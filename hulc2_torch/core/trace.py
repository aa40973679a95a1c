"""Spans and counters on the train path, off unless a caller turns them on.

    from hulc2_torch.core import trace
    with trace.span("train.forward"):
        ...
    trace.count("train.host_syncs", 1)

Off (the default), ``span`` checks one module flag and returns one shared
do-nothing context: it reads no clock, records nothing and makes no profiler
annotation, so a span on the hot path costs a flag check. ``enable()`` turns
recording on for the whole process; ``drain()`` returns what was recorded
and clears it; ``disable()`` turns it off again. ``tools/profile_train`` and
the tests are the callers that turn it on.

On, each span is kept as a ``Span`` (its id, name, the thread's native id,
the id of the span it opened inside on the same thread or 0, its start and
end on ``time.perf_counter_ns`` and its attributes), and while
``torch.profiler`` records it also enters ``record_function`` under its
label: the name, then `` key=value`` for each attribute in order
(``shift_normalize n=64 h=96 w=96 out=bfloat16``), so that the spans show in
Chrome traces. ``count`` adds to a named counter; ``device_counts`` counts,
over a block on the card, the host-device synchronisations its thread made
(CUDA's sync debug mode set to warn for the block and restored after), the
caching allocator's ``cudaMalloc`` calls and the pinned host allocator's
CUDA allocations. ``SyncCounter`` counts a block's synchronisations whether
tracing is on or not: the train step reads it on a signature's first call.
"""
from __future__ import annotations

import itertools
import re
import threading
import time
import warnings
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    id: int
    name: str
    thread: int  # threading.get_native_id() of the thread that ran it
    parent: int  # the id of the enclosing span on the same thread, 0 at the top
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    attrs: dict


_on = False
_spans: List[Span] = []
_counters: Dict[str, int] = defaultdict(int)
_count_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The context every span is while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def label(name: str, attrs: dict) -> str:
    """The span's profiler label: its name, then `` key=value`` per attribute."""
    return "".join([name, *(f" {k}={v}" for k, v in attrs.items())])


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "annotation")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(label(self.name, self.attrs))
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _stack().pop()
        _spans.append(Span(self.id, self.name, threading.get_native_id(), self.parent,
                           self.start, end, self.attrs))
        return False


def span(name: str, **attrs):
    """A context that records the block as a span while tracing is on."""
    if not _on:
        return OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _on:
        return
    with _count_lock:
        _counters[name] += int(n)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> dict:
    """{"spans": [Span, ...] in the order they ended, "counters": {name: n}},
    and both cleared."""
    with _count_lock:
        spans, counters = list(_spans), dict(_counters)
        del _spans[:len(spans)]
        _counters.clear()
    return {"spans": spans, "counters": counters}


SYNC_WARNING = "called a synchronizing CUDA operation"


class SyncCounter:
    """A context that counts, in ``n``, the host-device synchronisations the
    entering thread makes in the block, whether tracing is on or not: each a
    warning of CUDA's sync debug mode, which is set to ``warn`` for the block
    and restored after; the warnings are not shown. Counters nest: an outer
    one counts what an inner one counts."""

    def __enter__(self):
        self.thread, self.n = threading.get_ident(), 0
        self.mode = torch.cuda.get_sync_debug_mode()
        self.catch = warnings.catch_warnings()
        self.catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self.shown = warnings.showwarning
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _show(self, message, category, *args, **kwargs):
        if threading.get_ident() == self.thread and re.match(SYNC_WARNING, str(message)):
            self.n += 1
            if not isinstance(getattr(self.shown, "__self__", None), SyncCounter):
                return
        self.shown(message, category, *args, **kwargs)

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.mode)
        self.catch.__exit__(*exc)
        return False


class _DeviceCounts:
    """``device_counts`` while tracing on the card."""

    def __init__(self, device: torch.device, syncs: Optional[str], mallocs: Optional[str],
                 pinned: Optional[str]):
        self.device, self.syncs, self.mallocs, self.pinned = device, syncs, mallocs, pinned

    def __enter__(self):
        if self.mallocs:
            self.malloc0 = torch.cuda.memory_stats(self.device)["num_device_alloc"]
        if self.pinned:
            self.pinned0 = torch.cuda.host_memory_stats()["num_host_alloc"]
        if self.syncs:
            self.sync_counter = SyncCounter().__enter__()
        return self

    def __exit__(self, *exc):
        if self.syncs:
            self.sync_counter.__exit__(*exc)
            count(self.syncs, self.sync_counter.n)
        if self.pinned:
            count(self.pinned, torch.cuda.host_memory_stats()["num_host_alloc"]
                  - self.pinned0)
        if self.mallocs:
            count(self.mallocs, torch.cuda.memory_stats(self.device)["num_device_alloc"]
                  - self.malloc0)
        return False


def device_counts(device, syncs: Optional[str] = None, mallocs: Optional[str] = None,
                  pinned: Optional[str] = None):
    """While tracing on the card, a context that adds to the counter named
    ``syncs`` the host-device synchronisations the entering thread makes in
    the block (each a warning of CUDA's sync debug mode, which is set to
    ``warn`` for the block and restored after; the warnings are not shown),
    to ``mallocs`` the caching allocator's ``cudaMalloc`` calls and to
    ``pinned`` the pinned host allocator's CUDA allocations. The two
    allocators are the process's: their counts take in other threads' work
    in the block. Off, or off the card, the shared do-nothing context."""
    if not _on:
        return OFF
    device = torch.device(device)
    if device.type != "cuda":
        return OFF
    return _DeviceCounts(device, syncs, mallocs, pinned)
