"""The training path without the device store against the JAX package, on the CPU.

``cfg_low_level`` assembles every training batch on the host: the native npz
loader (byte for byte against ``np.load`` and the JAX ``NpzFrameStore``,
and raising where the JAX binding falls back), ``FusedBatchLoader`` (every
batch of two epochs equal to the JAX loader's, embeddings included), the
shared-memory cache (attach, cleanup, stale segments) and the training CLI
with ``--config-name`` and ``--shm-cache``. The pinned ring of the card's
path is tested on the card (``test_torch_port_host_loader_card.py``).
"""
import json
import os
from multiprocessing import shared_memory
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_dataset import dm_cfg, write_calvin_dir
from hulc2_torch import training
from hulc2_torch.data import native_loader
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.frame_store import NpzFrameStore, RamFrameStore
from hulc2_torch.data.loader import DevicePrefetcher, FusedBatchLoader
from hulc2_torch.kernels import build

KEYS = ["rgb_static", "rgb_gripper", "robot_obs", "rel_actions"]
EMB_DIM = 384
# cfg_low_level at tiny width: 2 + 2 windows of 3-4 frames, 2 steps and 1 val batch
LOW_TINY = [
    "model.plan_proposal.hidden_size=32", "model.plan_recognition.encoder_hidden_size=32",
    "model.plan_recognition.fc_hidden_size=32", "model.visual_goal.hidden_size=32",
    "model.language_goal.hidden_size=32", "model.action_decoder.hidden_size=32",
    "datamodule.batch_size_vis=2", "datamodule.batch_size_lang=2", "datamodule.min_window_size=3",
    "datamodule.max_window_size=4", "datamodule.num_workers=2", "trainer.log_every_n_steps=1",
    "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
]


def write_low_level_dir(root: Path, static_hw: int = 200, gripper_hw: int = 84, **kw) -> Path:
    """``write_calvin_dir``'s dataset (at the ``rand_shift`` preset's sizes by
    default; ``kw`` for its other options) with 384-d hash embeddings of its
    sentences and each split's ``embeddings.npy`` table of the canonical
    validation sentences: the layout ``make_expert_dataset`` writes without
    ``--lang-tokens``."""
    from hulc2_torch.evaluation.tasks import TASK_NAMES
    from hulc2_torch.tools.annotations import VALIDATION_BANK
    from hulc2_torch.tools.auto_lang_annotator import hash_embed

    write_calvin_dir(root, static_hw=static_hw, gripper_hw=gripper_hw, **kw)
    for split in ("training", "validation"):
        d = Path(root) / split / kw.get("lang_folder", "lang_annotations")
        ann = np.load(d / "auto_lang_ann.npy", allow_pickle=True).item()
        ann["language"]["emb"] = hash_embed(ann["language"]["ann"], EMB_DIM)[:, None]
        np.save(d / "auto_lang_ann.npy", ann, allow_pickle=True)
        table = {t: {"ann": [VALIDATION_BANK[t]], "emb": hash_embed([VALIDATION_BANK[t]], EMB_DIM)}
                 for t in TASK_NAMES}
        np.save(d / "embeddings.npy", table, allow_pickle=True)
    return Path(root)


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    """16 px frames: the loader's layout at a small size."""
    return write_low_level_dir(tmp_path_factory.mktemp("low16"), 16, 16)


@pytest.fixture(scope="module")
def low_dir(tmp_path_factory):
    return write_low_level_dir(tmp_path_factory.mktemp("low200"))


def _host_cfg(root, **kw) -> dict:
    cfg = dm_cfg(root, load_lang_embeddings=True, **kw)
    cfg["device_store"] = False
    return cfg


# ---- the native loader ------------------------------------------------- #
@pytest.mark.parametrize("start,size", [(0, 1), (37, 12), (100, 32)])
def test_native_reads_equal_np_load_and_jax(low_dir, start, size):
    """Windows at 200/84 px: the native reads, the per-frame ``np.load``
    reader and the JAX ``NpzFrameStore.load_window``, byte for byte."""
    from hulc2_tpu.data.frame_store import NpzFrameStore as JaxNpz

    d = low_dir / "training"
    got = NpzFrameStore(d, KEYS).load_window(start, size)
    plain = NpzFrameStore(d, KEYS).load_window_plain(start, size)
    want = JaxNpz(d, KEYS).load_window(start, size)
    assert set(got) == set(plain) == set(want) == set(KEYS)
    for k in KEYS:
        assert got[k].dtype == plain[k].dtype == want[k].dtype and got[k].shape[0] == size
        assert got[k].tobytes() == plain[k].tobytes() == want[k].tobytes(), k
    assert got["rgb_static"].shape[1:] == (200, 200, 3)
    path = NpzFrameStore(d, KEYS).frame_path(start)
    assert native_loader.probe_entry_bytes(path, "rgb_gripper") == 84 * 84 * 3


def test_native_reads_deflated_entries(tmp_path):
    """``np.savez_compressed`` frames (deflated entries, read and inflated)
    and a key that sits behind others in the archive, against ``np.load``."""
    rng = np.random.default_rng(0)
    frames = [{"rgb_static": rng.integers(0, 256, (20, 20, 3), dtype=np.uint8),
               "robot_obs": rng.normal(size=15).astype(np.float32)} for _ in range(5)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"frame_{i:07d}.npz"))
        (np.savez_compressed if i % 2 else np.savez)(paths[-1], **f)
    for k in ("rgb_static", "robot_obs"):
        out = np.empty((len(paths), *frames[0][k].shape), frames[0][k].dtype)
        native_loader.load_frames_into(paths, k, out, n_threads=2)
        np.testing.assert_array_equal(out, np.stack([f[k] for f in frames]))


def test_native_loader_raises(small_dir, tmp_path):
    """Every error of the loader raises, with its name: a missing key, a
    buffer whose rows are longer or shorter than the entry, a missing file;
    a buffer that is not contiguous is refused before the call."""
    store = NpzFrameStore(small_dir / "training", KEYS)
    paths = [store.frame_path(i) for i in range(3)]
    cases = [("no_such_key", np.empty((3, 16, 16, 3), np.uint8), "entry not found"),
             ("rgb_static", np.empty((3, 16, 16, 2), np.uint8), "output buffer too small"),
             ("rgb_static", np.empty((3, 16, 16, 4), np.uint8), "entry size differs")]
    for key, out, msg in cases:
        with pytest.raises(RuntimeError, match=msg):
            native_loader.load_frames_into(paths, key, out)
    with pytest.raises(RuntimeError, match="file read failed"):
        native_loader.load_frames_into([str(tmp_path / "missing.npz")], "rgb_static",
                                       np.empty((1, 16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        native_loader.load_frames_into(paths, "rgb_static", np.empty((3, 16, 16, 6), np.uint8)[..., :3])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No g++, or a source that does not compile: the build raises (the JAX
    binding returns None and falls back to ``np.load``)."""
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native_loader.get_lib()
    monkeypatch.undo()
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "frameloader.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="native build failed"):
        native_loader.get_lib()


# ---- the fused host loader ---------------------------------------------- #
@pytest.mark.parametrize("num_threads", [1, 3])
def test_fused_batch_loader_equals_jax(small_dir, num_threads):
    """The datamodule's host loader (npz store, native reads) against the
    JAX package's ``FusedBatchLoader`` over two epochs: every key, dtype and
    value, the lang rows' embeddings included; then through the prefetcher."""
    from hulc2_tpu.data.datamodule import Hulc2DataModule as JaxDataModule

    cfg = _host_cfg(small_dir, batch_vis=3, batch_lang=2)
    cfg["num_workers"] = num_threads
    dm = Hulc2DataModule(cfg, seed=7, device="cpu")
    dm.setup()
    loader = dm.fused_train_iter()
    assert isinstance(loader, FusedBatchLoader) and dm.device_store is None
    assert isinstance(dm.datasets["vis_training"].store, NpzFrameStore)
    jdm = JaxDataModule(cfg, seed=7)
    jdm.setup()
    ref = jdm.fused_train_iter()
    assert len(loader) == len(ref) == dm.steps_per_epoch() > 2
    for epoch in range(2):
        n = 0
        for got, want in zip(loader, ref):
            assert set(got) == set(want)
            for k, w in want.items():
                assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
                np.testing.assert_array_equal(got[k], w, err_msg=f"epoch {epoch} {k}")
            n += 1
        assert n == len(ref)
    assert got["lang"].shape == (2, EMB_DIM) and got["lang"].dtype == np.float32
    loader.epoch = ref.epoch = 1
    it = DevicePrefetcher(loader, "cpu")
    for got, want in zip(it, ref):
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    it.close()


def test_shared_memory_cache_attaches_cleans_up_and_unlinks_stale(small_dir):
    """A segment left by a crashed run is unlinked and made anew; a second
    store attaches to the first's segments (a write through one shows in
    the other) and does not unlink them; the owner's cleanup does."""
    d = small_dir / "training"
    ids = np.load(d / "ep_start_end_ids.npy")
    tag = f"port_shm_{os.getpid()}"
    from hulc2_tpu.data.frame_store import RamFrameStore as JaxRam

    stale = shared_memory.SharedMemory(name=f"hulc2_{tag}_rgb_static", create=True, size=16)
    stale.close()
    # the JAX store attaches to a stale segment of another size and fails
    # (``hulc2_tpu/data/frame_store.py:158-170``); the port's unlinks it
    with pytest.raises(TypeError, match="buffer is too small"):
        JaxRam(NpzFrameStore(d, KEYS), ids, ["rgb_static"], use_shm=True, shm_tag=tag)
    ram = RamFrameStore(NpzFrameStore(d, KEYS), ids, KEYS)
    owner = RamFrameStore(NpzFrameStore(d, KEYS), ids, KEYS, use_shm=True, shm_tag=tag)
    try:
        assert owner.owner and owner.arrays["rgb_static"].nbytes == ram.arrays["rgb_static"].nbytes
        other = RamFrameStore(NpzFrameStore(d, KEYS), ids, KEYS, use_shm=True, shm_tag=tag)
        assert not other.owner
        for k in KEYS:
            np.testing.assert_array_equal(owner.arrays[k], ram.arrays[k])
            np.testing.assert_array_equal(other.arrays[k], ram.arrays[k])
        owner.arrays["robot_obs"][0, 0] += 1.0
        assert other.arrays["robot_obs"][0, 0] == ram.arrays["robot_obs"][0, 0] + 1.0
        owner.arrays["robot_obs"][0, 0] -= 1.0
        other.drop_arrays(KEYS)  # shared: nothing is dropped
        assert set(other.arrays) == set(KEYS)
        other.cleanup()
        shared_memory.SharedMemory(name=f"hulc2_{tag}_rgb_static").close()  # still there
    finally:
        owner.cleanup()
    for k in KEYS:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=f"hulc2_{tag}_{k}")


def test_datamodule_shm_cache_gives_the_npz_batches(small_dir):
    """``use_shm_cache``: the training split comes from the shared-memory
    cache, the batches are the npz path's, and ``close`` unlinks it."""
    cfg = _host_cfg(small_dir)
    plain = Hulc2DataModule(cfg, seed=7, device="cpu")
    shm = Hulc2DataModule(cfg, seed=7, device="cpu", use_shm_cache=True)
    plain.setup()
    shm.setup()
    try:
        store = shm.datasets["vis_training"].store
        assert isinstance(store, RamFrameStore) and store.owner
        for got, want in zip(shm.fused_train_iter(), plain.fused_train_iter()):
            for k, w in want.items():
                np.testing.assert_array_equal(got[k], w, err_msg=k)
    finally:
        shm.close()
    assert store.arrays == {}


# ---- the training CLI ----------------------------------------------------- #
def test_training_cli_trains_the_default_config(low_dir, tmp_path):
    """``--config-name cfg_low_level`` on the CPU, from the npz files and
    again with ``--shm-cache``: the run's config is the registry's root
    (no device store, the rand_shift preset, no text tower), the host path
    reports no store, both runs take the same batches (bit-equal losses)."""
    from hulc2_torch.core.config import compose

    argv = ["--config-name", "cfg_low_level", "--device", "cpu", "--max-epochs", "1",
            f"datamodule.root_data_dir={low_dir}", *LOW_TINY]
    npz = training.main(argv + ["--run-dir", str(tmp_path / "npz")])
    shm = training.main(argv + ["--run-dir", str(tmp_path / "shm"), "--shm-cache"])
    cfg = json.loads((tmp_path / "npz" / "config.json").read_text())
    assert cfg == compose("cfg_low_level", [f"datamodule.root_data_dir={low_dir}", *LOW_TINY])
    assert cfg["datamodule"]["device_store"] is False and cfg["datamodule"]["transforms"] == "rand_shift"
    assert npz.model.lang_net is None and npz.model.lang_task_head is None
    for r in (npz, shm):
        assert r.step == 2 and r.store_nbytes is None and r.store_upload_s is None
        assert len(r.val_history) == 1 and all(np.isfinite(v) for line in r.history for v in line.values())
    assert [x["train/loss"] for x in npz.history] == [x["train/loss"] for x in shm.history]
    assert all("train/lang_task_loss" not in x for x in npz.history)
    assert (tmp_path / "shm" / "saved_models" / "2.pt").is_file()


def test_training_cli_refuses(low_dir, tmp_path):
    for argv in (["--config-name", "no_such_root"], ["--synthetic", "--max-steps", "1", "--shm-cache"],
                 ["--config-name", "cfg_low_level", "model/language_encoder=no_such_option"]):
        with pytest.raises((SystemExit, KeyError)):
            training.main(argv + ["--device", "cpu", "--run-dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            training.main(["--config-name", "cfg_low_level", "--run-dir", str(tmp_path),
                           f"datamodule.root_data_dir={low_dir}", *LOW_TINY])
