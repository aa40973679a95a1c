"""Each cell end to end at a tiny size on the CPU, the program against the
plain reference, with the cell's own limits; the timed path broken
underneath makes ``correct`` false; without a card the benchmark refuses."""
import json
import subprocess
import sys

import pytest
import torch

from portbench.harness import check, spec
from portbench.tests.tiny import ROOT, context, tiny_cell

TRAIN_CELLS = ["flagship.train.store"]
CPU_LIMIT = 1e-9  # a sound run's numbers on the CPU: 0, and 4e-15 where two round-off norms meet


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, tmp_path, **kw):
    cell = tiny_cell(name)
    rec = spec.runner(cell["traffic"]).run(context(cell, tmp_path, **kw))
    ok, checks = check.verdict(rec["checks"], cell["limits"])
    return rec, ok, checks


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_cell_runs_and_is_correct(name, tmp_path):
    rec, ok, checks = _run(name, tmp_path)
    assert ok, checks
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert rec["e2e"]["train_samples_per_s"] > 0 and rec["e2e"]["setup_s"] > 0
    # on the CPU the program computes in fp32 as the reference does, op for
    # op: every number reads 0 to rounding
    assert all(c["value"] <= CPU_LIMIT for c in checks.values()), checks
    # no leaf of the flagship is left without a gradient: nothing to hold still
    assert rec["checks"]["frozen_update"] == 0.0
    assert rec["check_detail"]["frozen_leaves"] == 0


@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_train_cell_fault_is_not_correct(name, fault, tmp_path):
    """The fault under the CPU's own limits: a sound run reads every number
    0 to rounding here (above), so each is held to ``CPU_LIMIT``. The cell's limits are set
    for the card's bf16 step at full size, where the card tests
    (``test_portbench_control.py``) hold the faults to them; at this size a
    half batch moves the step-1 loss by ~1e-4 only."""
    cell = tiny_cell(name)
    rec = spec.runner(cell["traffic"]).run(context(cell, tmp_path, fault=fault))
    ok, checks = check.verdict(rec["checks"], {k: CPU_LIMIT for k in cell["limits"]})
    assert not ok, checks
    if fault == "frozen":  # the state left unchanged fails the cell's own limits too
        assert not check.verdict(rec["checks"], cell["limits"])[0], checks


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "flagship.train.store", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's folder."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "flagship.train.store", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_result_line_from_a_record():
    from portbench.run import result

    bench = spec.load_benchmark(ROOT)
    cell = spec.load_cell(bench, "flagship.train.store")
    rec = {"attempted": 10, "failed": 0,
           "e2e": {"train_samples_per_s": 900.0, "train_step_p95_ms": 80.0, "setup_s": 30.0},
           "checks": {k: 0.0 for k in cell["limits"]},
           "layers": {"batch_wait_s": [0.001, 0.003], "steps": 2, "window_s": 0.2,
                      "flops_per_step": 3.7e11, "crops": [(2048, 96, 96)], "crop_out_bytes": 2,
                      "profile": {"busy_s": 0.03, "window_s": 0.12, "steps": 2,
                                  "by_name": {"shift_normalize_kernel": (1e-4, 2)}}}}
    out, checks = result(bench, cell, rec, False, cell["limits"])
    assert out["correct"] and set(out["metrics"]) == {"train_samples_per_s", "train_step_p95_ms",
                                                      "setup_s"}
    out, _ = result(bench, cell, rec, True, cell["limits"])
    assert out["metrics"]["data.batch_wait_ms"]["value"] == pytest.approx(2.0)
    assert out["metrics"]["device_idle_pct.train"]["value"] == pytest.approx(75.0)
    json.dumps(out)
