"""Where the time of the flagship train step goes, on the card.

    python -m hulc2_torch.tools.profile_train [--steps 5] [--warmup 5] [--trace OUT.json]
        [key=value ...]

Takes ``--warmup`` steps, times ``--steps`` more on the host clock (each
ending in a device synchronise), then runs ``--steps`` steps under
``torch.profiler`` and prints, per step: the wall time without and with the
profiler, the device-busy time (union of the kernels' intervals), the idle
share (the rest of the unprofiled wall time), the count of kernels and
copies, the device time by kernel family and the top kernels. ``--trace``
writes the Chrome trace. Counterpart of ``hulc2_tpu/tools/profile_train.py``;
the overrides are those of ``hulc2_torch.training``.
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

import torch
from torch.profiler import ProfilerActivity, profile

from hulc2_torch.configs.flagship import flagship_config
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


def _timed_steps(run: SyntheticRun, n: int) -> List[float]:
    times = []
    for _ in range(n):
        raw = run.data.next_batch()
        torch.cuda.synchronize(run.device)
        t0 = time.perf_counter()
        run.step(raw)
        torch.cuda.synchronize(run.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--trace", default=None, help="write the Chrome trace here")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    run = SyntheticRun(flagship_config(args.overrides), device="cuda")
    _timed_steps(run, args.warmup)
    plain_ms = statistics.median(_timed_steps(run, args.steps))

    batches = [run.data.next_batch() for _ in range(args.steps)]
    torch.cuda.synchronize(run.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for raw in batches:
            run.step(raw)
        torch.cuda.synchronize(run.device)
        profiled_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    # device activity: kernels, memcpys and memsets; not the device-side spans
    # of user annotations such as "Optimizer.step#Adam.step"
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _union_us(spans) / 1e3 / args.steps
    by_name: Dict[str, List[float]] = defaultdict(list)
    for e in kernels:
        by_name[e.name].append(e.time_range.elapsed_us())
    by_family: Dict[str, float] = defaultdict(float)
    for name, times in by_name.items():
        by_family[family(name)] += sum(times) / 1e3 / args.steps

    print(f"card: {card}; torch {torch.__version__}")
    print(f"wall per step: {plain_ms:.2f} ms (median of {args.steps}, no profiler), "
          f"{profiled_ms:.2f} ms under the profiler")
    print(f"device busy per step: {busy_ms:.2f} ms; idle share {100 * (1 - busy_ms / plain_ms):.1f}% "
          f"of the unprofiled wall time ({100 * (1 - busy_ms / profiled_ms):.1f}% under the "
          f"profiler); {len(kernels) / args.steps:.0f} device activities (kernels, copies) per step")
    print("device time per step by kernel family:")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:<16} {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%")
    print("top kernels by device time per step:")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    for name, times in top:
        print(f"  {sum(times) / 1e3 / args.steps:8.3f} ms  x{len(times) // args.steps:<5d} {name[:100]}")


if __name__ == "__main__":
    main(sys.argv[1:])
