#!/usr/bin/env python3
"""Run one cell of the benchmark of ``hulc2_torch`` once.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

``CELL`` is a workload of ``BENCHMARK.json``. Its configuration, traffic
mix and limits are files of this folder found by name
(``harness/spec.py``); the traffic's runner (``runners/``) sets the cell up
from the seed, runs the measured window for ``S`` seconds and checks the
program's outputs against the plain reference (``reference/``). With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by ``metrics/<name>.py`` from
what the runner recorded. The last lines on standard error give each number
compared beside its limit, after the numbers read and not compared in the
cell (``read``); the last line on standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
[``breakdown``] and ``checks``.

Exits non-zero without a result when CUDA is absent or has fewer cards than
the cell asks for, when the program cannot be imported, and when the
process holds ``jax``, ``jaxlib``, ``flax``, ``optax`` or ``hulc2_tpu``
once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from portbench.harness import guard, spec  # noqa: E402


@dataclass
class Context:
    """What a runner gets: the cell's files, the run's arguments, its device
    and temporary directory."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: Path
    t_start: float
    fault: Optional[str] = None  # a broken timed path, for the tests of the check
    extra: dict = field(default_factory=dict)


def device_info(device, rec: dict, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if trace:
        prof = rec["layers"]["profile"]
        info["busy_s"] = prof["busy_s"]
        info["window_s"] = prof["window_s"]
    return info


def result(bench: dict, cell: dict, rec: dict, trace: bool, limits: dict) -> tuple:
    """(the result line's object without ``device``, the checks) from a runner's record."""
    from portbench.harness import check

    ok, checks = check.verdict(rec["checks"], limits)
    if trace:
        metrics = {}
        for m in spec.per_layer(bench, cell["entry"]["name"]):
            value = spec.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(rec["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in spec.end_to_end(bench, cell["entry"]["name"])}
    out = {"correct": ok, "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics}
    return out, checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    guard.pin_caches(ROOT)
    bench = spec.load_benchmark(ROOT)
    cell = spec.load_cell(bench, args.workload)
    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    device = torch.device("cuda", 0)
    runner = spec.runner(cell["traffic"])
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(args.workload, cell["config"], cell["traffic"], args.seed % 2 ** 63,
                      args.seconds, bool(args.trace), device, Path(tmp), T_START)
        rec = runner.run(ctx)
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window", file=sys.stderr)
        return 4
    out, checks = result(bench, cell, rec, bool(args.trace), cell["limits"])
    out["device"] = device_info(device, rec, bool(args.trace))
    if args.trace and "breakdown" in rec["layers"].get("profile", {}):
        out["breakdown"] = rec["layers"]["profile"]["breakdown"]
    out["checks"] = checks
    print("detail " + json.dumps({"checks": rec.get("check_detail"), **rec.get("diag", {})}),
          file=sys.stderr)
    for name in sorted(set(rec["checks"]) - set(checks)):
        print(f"read {name}: {float(rec['checks'][name])!r} (not compared in this cell)",
              file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
