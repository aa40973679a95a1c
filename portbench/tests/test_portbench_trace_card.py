"""A traced run of each cell on the card: the program slice gives every
metric that reads it, and the train step's three phases account for the
eager steps' device time. Marked ``cuda``: it skips without a card.

    python -m pytest -m cuda portbench/tests/test_portbench_trace_card.py
"""
import time

import pytest

from portbench.harness import spec
from portbench.run import Context, result
from portbench.tests.tiny import ROOT

BENCH = spec.load_benchmark(ROOT)
PROGRAM_METRICS = ["train_step.forward_device_ms", "train_step.backward_device_ms",
                   "train_step.optimizer_device_ms", "model.encode_device_ms", "data.produce_ms"]
PHASES = ("train.forward", "train.backward", "train.optimizer")


@pytest.mark.cuda
def test_traced_run_reads_the_program_slice(tmp_path, cuda_device):
    name = "flagship.train.store"
    cell = spec.load_cell(BENCH, name)
    ctx = Context(name, cell["config"], cell["traffic"], 3600000017, 2.0, True, cuda_device,
                  tmp_path, time.perf_counter())
    rec = spec.runner(cell["traffic"]).run(ctx)
    out, checks = result(BENCH, cell, rec, True, cell["limits"])
    assert out["correct"], checks
    assert rec["checks"]["frozen_update"] == 0.0
    metrics = {m["name"] for m in spec.per_layer(BENCH, name)}
    assert metrics <= set(out["metrics"]), sorted(metrics - set(out["metrics"]))
    assert all(out["metrics"][m]["value"] > 0 for m in PROGRAM_METRICS), out["metrics"]
    eager = rec["layers"]["program"]["eager"]
    phases = sum(eager["spans"][p]["device_ms"] for p in PHASES)
    assert phases == pytest.approx(eager["busy_ms"], rel=0.10), (phases, eager["busy_ms"])
