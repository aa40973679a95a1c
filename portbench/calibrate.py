#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 portbench/calibrate.py --workload CELL --seeds 1 2 ... \
        [--control-seeds ...] [--fault half_batch --fault-seeds ...]

For each seed of ``--seeds`` the program's numbers (the runner's set-up and
its checked steps, no window), for each of ``--control-seeds`` the
control's (the runner's ``control``: the reference in a lower precision in
the program's place), for each of ``--fault-seeds`` the program with the
timed path broken by ``--fault``. One JSON line per reading, with each
leaf's gaps in its detail; all in one process. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from portbench.harness import guard, spec  # noqa: E402
from portbench.run import Context  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    guard.pin_caches(ROOT)
    import torch

    bench = spec.load_benchmark(ROOT)
    cell = spec.load_cell(bench, args.workload)
    runner = spec.runner(cell["traffic"])
    device = torch.device("cuda", 0)
    runs = ([("program", s, None) for s in args.seeds]
            + [("control", s, None) for s in args.control_seeds]
            + [(f"fault:{args.fault}", s, args.fault) for s in args.fault_seeds])
    for kind, seed, fault in runs:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            ctx = Context(args.workload, cell["config"], cell["traffic"], seed % 2 ** 63,
                          0.0, False, device, Path(tmp), t0, fault=fault,
                          extra={"leaf_detail": True})
            rec = runner.control(ctx) if kind == "control" else runner.run(ctx)
        torch.cuda.empty_cache()
        print(json.dumps({"kind": kind, "seed": seed, "checks": rec["checks"],
                          "detail": rec["check_detail"], "s": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
