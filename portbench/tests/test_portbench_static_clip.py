"""The ``static_clip_rn50.train.store`` cell: at a tiny size on the CPU
through ``runners/train.run`` (tiny ``tower_kwargs`` on both sides), the
three readers it adds on hand-built records, and the FLOP count of its
frozen trunk. Marked ``cuda``: the cell at full size on the card.

    python -m pytest portbench/tests/test_portbench_static_clip.py
    python -m pytest -m cuda portbench/tests/test_portbench_static_clip.py  # on the card

The control and the faults at full size against the cell's limits are
``test_portbench_control.py``'s, which takes every cell of the benchmark.
"""
import time

import pytest
import torch

from portbench.harness import check, counts, frozen_trunk, spec
from portbench.run import Context
from portbench.tests.tiny import ROOT, context, tiny_cell

CELL = "static_clip_rn50.train.store"
TOWER = {"layers": [1, 1, 1, 1], "width": 8, "heads": 2, "output_dim": 32}
# the trunk's parameter tensors: a convolution and a BatchNorm's scale and
# shift each (the stem's 3, each block's 3 and its downsample's), the pool's
# table and its 4 linears' weights and biases
TINY_TRUNK_LEAVES = 3 * (3 + 4 * 4) + 9  # layers (1, 1, 1, 1)
RN50_LEAVES = 3 * (3 + 16 * 3 + 4) + 9  # layers (3, 4, 6, 3): 174
# The reference normalises each convolution's output where the port folds
# the BatchNorm into the kernel (``models/resnet.conv_bn``): fp32 rounding in
# another order at each of the trunk's convolutions. Over five seeds the tiny
# cell reads update_gap 2.4e-7 to 2.2e-6 and still_grad_gap 5e-10 to 6.8e-8
# (loss1_gap 0), not the flagship's 0 to 4e-15; a half batch reads 5.9e-4
# and 0.17, the frozen state 1.0. Each number is held to 2e-5 here.
CPU_LIMIT = 2e-5
NEW_READERS = ["model.encode_static_device_ms", "vision.frozen_trunk_device_ms",
               "vision.frozen_trunk_mfu"]
# the older readers that list the cell, and those that read it unchanged but
# whose lists ``test_portbench_program.py`` holds to the flagship alone
LISTED = ["data.batch_wait_ms", "train_step.busy_ms", "train_step.mfu", "device_idle_pct.train"]
UNLISTED = ["train_step.forward_device_ms", "train_step.backward_device_ms",
            "train_step.optimizer_device_ms", "model.encode_device_ms", "data.produce_ms"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny():
    cell = tiny_cell(CELL)
    cell["config"]["config"]["model"]["perceptual_encoder"]["rgb_static"]["tower_kwargs"] = TOWER
    return cell


def test_the_cell_at_its_published_widths():
    cell = spec.load_cell(spec.load_benchmark(ROOT), CELL)
    cfg = cell["config"]["config"]
    static = cfg["model"]["perceptual_encoder"]["rgb_static"]
    assert static == {"_name_": "vision_clip", "visual_features": 64, "model_name": "RN50",
                      "freeze_backbone": True}  # no tower_kwargs: RN50's own sizes
    assert cfg["datamodule"]["transforms"] == "clip" and cfg["model"]["compute_dtype"] == "bfloat16"
    assert (cell["traffic"]["static_hw"], cell["traffic"]["gripper_hw"]) == (200, 84)
    assert cell["limits"]["frozen_update"] == 0 and cell["entry"]["chips"] == 1


def test_tiny_cell_runs_and_is_correct(tmp_path):
    cell = _tiny()
    rec = spec.runner(cell["traffic"]).run(context(cell, tmp_path))
    ok, checks = check.verdict(rec["checks"], cell["limits"])
    assert ok, checks
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert all(c["value"] <= CPU_LIMIT for c in checks.values()), checks
    # the trunk's leaves are the frozen ones, and none of them moved
    assert rec["checks"]["frozen_update"] == 0.0
    assert rec["check_detail"]["frozen_leaves"] == TINY_TRUNK_LEAVES
    assert rec["check_detail"]["frozen_leaf"].startswith("perceptual_encoder.rgb_static_encoder.clip.")


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_tiny_cell_fault_is_not_correct(fault, tmp_path):
    cell = _tiny()
    rec = spec.runner(cell["traffic"]).run(context(cell, tmp_path, fault=fault))
    ok, checks = check.verdict(rec["checks"], {k: CPU_LIMIT for k in cell["limits"]})
    assert not ok, checks
    if fault == "frozen":
        assert not check.verdict(rec["checks"], cell["limits"])[0], checks


def test_trunk_flops_are_the_plain_towers_and_the_ports():
    """11.59 GFLOP a frame of 224 x 224 (products only), from the reference's
    tower; the port's tower counts the same."""
    from hulc2_torch.models.clip_resnet import ClipModifiedResNet

    flops = frozen_trunk.flops_per_frame("vision.frozen_trunk_mfu")
    assert flops == 11_586_306_048
    with torch.device("meta"):
        tower = ClipModifiedResNet(224)
    x = torch.empty(1, 3, 224, 224, device="meta")
    with torch.no_grad():
        assert counts.count_flops(lambda: tower(x), "meta")["flops"] == flops
    assert frozen_trunk.flops_per_frame("model.encode_device_ms") is None  # the flagship has none


def _rec(eager_spans, counters):
    return {"layers": {"program": {"eager": {"steps": 2, "spans": eager_spans,
                                             "counters": counters},
                                   "replayed": {"steps": 2, "spans": {}, "counters": {}}}}}


def test_readers_of_the_new_spans():
    spans = {"model.encode": {"calls": 1.0, "host_ms": 30.0, "device_ms": 120.0},
             "model.encode.rgb_static": {"calls": 1.0, "host_ms": 25.0, "device_ms": 118.0},
             "vision.frozen_trunk": {"calls": 1.0, "host_ms": 24.0, "device_ms": 100.0}}
    rec = _rec(spans, {"vision.frozen_trunk_frames": 2048.0})
    read = {name: spec.reader(name)(rec) for name in NEW_READERS}
    assert read["model.encode_static_device_ms"] == 118.0
    assert read["vision.frozen_trunk_device_ms"] == 100.0
    # 11.59 GFLOP x 2048 frames in 0.1 s over 989 TFLOP/s
    assert read["vision.frozen_trunk_mfu"] == pytest.approx(
        11_586_306_048 * 2048 / 0.1 / counts.H100_BF16_FLOPS)


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_reader_without_the_program_slice_reads_none(name):
    rec = {"layers": {"steps": 2, "window_s": 0.2, "batch_wait_s": [0.001],
                      "profile": {"busy_s": 0.03, "window_s": 0.12, "steps": 2, "by_name": {}}}}
    assert spec.reader(name)(rec) is None
    assert spec.reader(name)(_rec({}, {})) is None
    # a program without the new spans (the parent's): the older spans only
    assert spec.reader(name)(_rec({"model.encode": {"calls": 1.0, "host_ms": 3.0,
                                                    "device_ms": 3.4}}, {})) is None


def test_the_cell_is_in_the_benchmark():
    bench = spec.load_benchmark(ROOT)
    reported = {m["name"] for m in spec.per_layer(bench, CELL)}
    assert reported == set(NEW_READERS + LISTED)
    for m in bench["per_layer"]:
        if m["name"] in NEW_READERS:
            assert m["workloads"] == [CELL] and m["moves"] == "train_samples_per_s"
    assert {m["name"] for m in spec.end_to_end(bench, CELL)} == {
        "train_samples_per_s", "train_step_p95_ms", "setup_s"}


@pytest.mark.cuda
def test_the_cell_on_the_card(tmp_path, cuda_device):
    """The cell at full size, traced, on the card: correct, the trunk's 174
    leaves held still, every reader of the program slice reads, and the
    trunk's frames a step B x T."""
    bench = spec.load_benchmark(ROOT)
    cell = spec.load_cell(bench, CELL)
    ctx = Context(CELL, cell["config"], cell["traffic"], 5302262739, 3.0, True, cuda_device,
                  tmp_path, time.perf_counter())
    rec = spec.runner(cell["traffic"]).run(ctx)
    ok, checks = check.verdict(rec["checks"], cell["limits"])
    assert ok, checks
    assert rec["checks"]["frozen_update"] == 0.0
    assert rec["check_detail"]["frozen_leaves"] == RN50_LEAVES
    eager = rec["layers"]["program"]["eager"]
    assert eager["counters"]["vision.frozen_trunk_frames"] == 64 * 32
    assert eager["counters"]["train.host_syncs"] == 0
    for name in NEW_READERS + LISTED + UNLISTED:
        assert spec.reader(name)(rec) > 0, name
