"""The subprocess loader (``datamodule.loader_isolation=process``,
``data/process_loader.py``) against the thread loader it runs in its child,
on the CPU.

``FusedBatchLoader`` is held to the JAX loader batch for batch in
``test_torch_port_host_loader.py``; here the process loader's stream is held
to ``FusedBatchLoader``'s bit for bit: two full epochs, an epoch cut short
that resumes mid-stream (JAX's continuous stream), a start at a later epoch,
the real-robot layout (``rel_actions_gripper``, 6-channel tactile frames).
A child that dies or fails raises in the parent within its time limit, a
full ``/dev/shm`` is refused with the sizes, and no ``hulc2_pl_*`` segment
outlives ``close``. The training CLI trains through it with the losses of
the thread loader.
"""
import glob
import json
import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest

from hulc2_torch.data import process_loader
from hulc2_torch.data.datamodule import Hulc2DataModule
from test_torch_port_host_loader import LOW_TINY, _host_cfg, write_low_level_dir


@pytest.fixture(scope="module")
def pl_dir(tmp_path_factory):
    return write_low_level_dir(tmp_path_factory.mktemp("pl16"), 16, 16)


@pytest.fixture(scope="module")
def rw_dir(tmp_path_factory):
    """The real-robot layout: ``rel_actions_gripper``, tactile entries."""
    return write_low_level_dir(tmp_path_factory.mktemp("rw16"), 16, 12,
                               action_key="rel_actions_gripper", tactile_hw=10)


def _segments(loader) -> list:
    return glob.glob(f"/dev/shm/{process_loader.SEGMENT_PREFIX}{loader.tag}_*")


def _dms(root, **cfg_kw):
    """(the process loader's datamodule, the thread loader's) over ``root``."""
    out = []
    for isolation in ("process", "none"):
        cfg = _host_cfg(root, **cfg_kw)
        cfg["loader_isolation"] = isolation
        dm = Hulc2DataModule(cfg, seed=1, device="cpu")
        dm.setup()
        out.append(dm)
    return out


def _equal(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _stream(loader, n: int):
    """The first ``n`` batches of ``loader``'s epochs, in order."""
    out = []
    while len(out) < n:
        for batch in loader:
            out.append(batch)
            if len(out) == n:
                break
    return out


def test_two_full_epochs_equal_the_thread_loader(pl_dir):
    pdm, tdm = _dms(pl_dir)
    ploader, tloader = pdm.fused_train_iter(), tdm.fused_train_iter()
    assert len(ploader) == len(tloader) == 32
    try:
        for epoch in range(2):
            n = 0
            for got, want in zip(ploader, tloader):
                _equal(got, want, f"epoch {epoch} batch {n}")
                n += 1
            assert n == 32
        assert len(_segments(ploader)) == 3 * len(ploader.specs)
    finally:
        pdm.close()
    assert not _segments(ploader)


def test_a_cut_epoch_resumes_mid_stream(pl_dir):
    """Five batches, a break (``limit_train_batches``), then the next call:
    the stream goes on at batch 5 of epoch 0 into epoch 1, as JAX's does,
    where the thread loader would start epoch 1. A loader whose first call
    comes at epoch 3 (a resumed run) starts the stream there."""
    pdm, tdm = _dms(pl_dir)
    ploader, tloader = pdm.fused_train_iter(), tdm.fused_train_iter()
    want = _stream(tloader, 40)
    try:
        got = []
        for batch in ploader:
            got.append(batch)
            if len(got) == 5:
                break
        got += _stream(ploader, 35)
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"stream batch {i}")
    finally:
        pdm.close()
    pdm, tdm = _dms(pl_dir)
    ploader, tloader = pdm.fused_train_iter(), tdm.fused_train_iter()
    ploader.epoch = tloader.epoch = 3
    try:
        for i, (g, w) in enumerate(zip(_stream(ploader, 3), _stream(tloader, 3))):
            _equal(g, w, f"epoch 3 batch {i}")
    finally:
        pdm.close()


def test_real_robot_layout_through_the_child(rw_dir):
    """``rel_actions_gripper`` is padded by repetition (JAX's rule: it is not
    ``rel_actions``), the 6-channel ``rgb_tactile`` and 2-channel
    ``depth_tactile`` rows cross the shared slots unchanged."""
    obs = {"rgb_obs": ["rgb_static", "rgb_gripper", "rgb_tactile"],
           "depth_obs": ["depth_tactile"], "state_obs": ["robot_obs"],
           "actions": ["rel_actions_gripper"], "language": ["language"]}
    pdm, tdm = [], []
    for isolation, out in (("process", pdm), ("none", tdm)):
        cfg = _host_cfg(rw_dir)
        cfg.update(loader_isolation=isolation, observation_space=obs)
        dm = Hulc2DataModule(cfg, seed=2, device="cpu")
        dm.setup()
        out.append(dm)
    pdm, tdm = pdm[0], tdm[0]
    assert not pdm.datasets["vis_training"].relative_actions
    try:
        for i, (g, w) in enumerate(zip(_stream(pdm.fused_train_iter(), 4),
                                       _stream(tdm.fused_train_iter(), 4))):
            assert g["rgb_tactile"].shape[-3:] == (10, 10, 6)
            assert g["depth_tactile"].shape[-3:] == (10, 10, 2)
            _equal(g, w, f"batch {i}")
    finally:
        pdm.close()


def test_a_killed_child_raises_in_time_and_leaves_no_segment(pl_dir):
    pdm, _ = _dms(pl_dir)
    loader = pdm.fused_train_iter()
    loader.TIMEOUT_S = 20.0
    it = iter(loader)
    next(it)
    os.kill(loader._proc.pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died"):
        for _ in range(loader.RING_SLOTS + 1):  # the slots written before the kill come first
            next(it)
    assert time.monotonic() - t0 < 10
    pdm.close()
    assert not _segments(loader)


def test_a_failing_child_raises_its_error(pl_dir, tmp_path):
    pdm, _ = _dms(pl_dir)
    loader = pdm.fused_train_iter()
    loader._spec["dm_cfg"]["root_data_dir"] = str(tmp_path / "gone")
    try:
        with pytest.raises(RuntimeError, match="failed:(.|\n)*gone"):
            next(iter(loader))
    finally:
        pdm.close()
    assert not _segments(loader)


def test_full_dev_shm_is_refused_with_the_sizes(pl_dir, monkeypatch):
    pdm, _ = _dms(pl_dir)
    loader = pdm.fused_train_iter()
    monkeypatch.setattr(process_loader.shutil, "disk_usage",
                        lambda path: type("U", (), {"free": 1 << 10})())
    try:
        with pytest.raises(RuntimeError, match=r"MiB free.*3 slots need"):
            next(iter(loader))
        assert loader._proc is None and not _segments(loader)
    finally:
        pdm.close()


def test_isolation_options_and_refusals(pl_dir):
    cfg = _host_cfg(pl_dir)
    cfg["loader_isolation"] = "thread"
    with pytest.raises(ValueError, match="loader_isolation"):
        Hulc2DataModule(cfg, device="cpu")
    cfg.update(loader_isolation="process", datasets={"vis": True, "lang": False})
    with pytest.raises(NotImplementedError, match="process loader"):
        Hulc2DataModule(cfg, device="cpu")


def test_training_cli_through_the_process_loader(pl_dir, tmp_path):
    """``datamodule.loader_isolation=process``: the CLI's two steps have the
    thread loader's losses, and the run leaves no segment behind."""
    from hulc2_torch import training

    lines = {}
    for isolation in ("none", "process"):
        run = tmp_path / isolation
        training.main(["--config-name", "cfg_low_level", "--run-dir", str(run), "--max-epochs", "1",
                       "--device", "cpu", f"datamodule.root_data_dir={pl_dir}",
                       f"datamodule.loader_isolation={isolation}",
                       "datamodule.lang_folder=lang_annotations", *LOW_TINY])
        lines[isolation] = [json.loads(l) for l in (run / "metrics.jsonl").read_text().splitlines()
                            if '"train/loss"' in l]
    assert len(lines["process"]) == 2
    for a, b in zip(lines["none"], lines["process"]):
        assert a["train/loss"] == b["train/loss"]
    assert not glob.glob(f"/dev/shm/{process_loader.SEGMENT_PREFIX}{os.getpid()}_*")


def test_the_child_attaches_to_the_shared_memory_cache(pl_dir):
    """With ``--shm-cache`` the parent's datamodule holds the training split
    in shared memory; the child attaches to those segments (the same files,
    not new ones made in their place) and gives the thread loader's batches."""
    cfg = _host_cfg(pl_dir)
    cfg["loader_isolation"] = "process"
    pdm = Hulc2DataModule(cfg, seed=1, device="cpu", use_shm_cache=True)
    pdm.setup()
    _, tdm = _dms(pl_dir)
    cache = sorted(Path("/dev/shm").glob("hulc2_*_rgb_static"))
    cache = [p for p in cache if not p.name.startswith(process_loader.SEGMENT_PREFIX)]
    assert cache
    inodes = {p: p.stat().st_ino for p in cache}
    try:
        for i, (g, w) in enumerate(zip(_stream(pdm.fused_train_iter(), 4),
                                       _stream(tdm.fused_train_iter(), 4))):
            _equal(g, w, f"batch {i}")
        assert {p: p.stat().st_ino for p in cache} == inodes
    finally:
        pdm.close()
