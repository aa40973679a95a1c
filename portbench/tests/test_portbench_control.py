"""The control of each cell on the card at the cell's own size: the
reference in fp8 mixed precision put in the program's place comes out as
not correct under the cell's limits, and so does each fault of the timed
path that the cell can have. Marked ``cuda``: they skip without a card.

    python -m pytest -m cuda portbench/tests/test_portbench_control.py
"""
import time

import pytest

from portbench.harness import check, spec
from portbench.run import Context
from portbench.tests.tiny import ROOT

BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
FAULTS = ["frozen", "half_batch"]


def _ctx(name, tmp_path, device, **kw):
    cell = spec.load_cell(BENCH, name)
    return cell, Context(name, cell["config"], cell["traffic"], 3600000001, 0.0, False,
                         device, tmp_path, time.perf_counter(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path, cuda_device):
    cell, ctx = _ctx(name, tmp_path, cuda_device)
    rec = spec.runner(cell["traffic"]).control(ctx)
    # the control reads the numbers that compare computations (its batches
    # and crops are the reference's own)
    limits = {k: v for k, v in cell["limits"].items() if k in rec["checks"]}
    ok, checks = check.verdict(rec["checks"], limits)
    assert limits and not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name, fault", [(c, f) for c in CELLS for f in FAULTS])
def test_fault_is_not_correct(name, fault, tmp_path, cuda_device):
    cell, ctx = _ctx(name, tmp_path, cuda_device, fault=fault)
    rec = spec.runner(cell["traffic"]).run(ctx)
    ok, checks = check.verdict(rec["checks"], cell["limits"])
    assert not ok, checks
