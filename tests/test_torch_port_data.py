"""The port's data path against the JAX package's, on the CPU.

Statistics, episode indices, frame stores and window datasets on a tiny
on-disk fixture; the dataset generator (the same files from the same seed);
the device-store loader (on the CPU here) against the JAX package's host
``FusedBatchLoader`` over two epochs; the prefetcher; the proprioception with
dataset statistics; the host copies of the annotation bank, the annotator's
hash embedding and the KL schedules.
"""
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_dataset import dm_cfg, host_fused_batches, write_calvin_dir
from hulc2_torch.data import episode_index as ei
from hulc2_torch.data.datamodule import Hulc2DataModule
from hulc2_torch.data.device_transforms import process_proprio
from hulc2_torch.data.frame_store import NpzFrameStore, RamFrameStore
from hulc2_torch.data.loader import DevicePrefetcher
from hulc2_torch.data.statistics import DatasetStatistics, load_statistics, parse_simple_yaml
from hulc2_torch.tools.make_expert_dataset import STATS_YAML, make_expert_dataset

KEYS = ["rgb_static", "rgb_gripper", "robot_obs", "rel_actions"]


@pytest.fixture(scope="module")
def calvin_dir(tmp_path_factory):
    return write_calvin_dir(tmp_path_factory.mktemp("calvin_port"))


def _jax_dm(root, seed=7, **kw):
    from hulc2_tpu.data.datamodule import Hulc2DataModule as JaxDataModule

    cfg = dm_cfg(root, **kw)
    cfg["device_store"] = False
    dm = JaxDataModule(cfg, seed=seed)
    dm.setup()
    return dm


def _port_dm(root, seed=7, **kw):
    dm = Hulc2DataModule(dm_cfg(root, **kw), seed=seed, device="cpu")
    dm.setup()
    return dm


class TestHostCopies:
    def test_statistics_equal_jax(self, calvin_dir, tmp_path):
        from hulc2_tpu.data.statistics import load_statistics as jax_load

        for d in (calvin_dir / "training", tmp_path):  # with and without statistics.yaml
            got, want = load_statistics(d), jax_load(d)
            for name in ("robot_obs_mean", "robot_obs_std", "scene_obs_mean", "scene_obs_std"):
                g, w = getattr(got, name), getattr(want, name)
                assert (g is None) == (w is None), name
                if w is not None:
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
            assert got.act_min_bound == want.act_min_bound
            assert got.act_max_bound == want.act_max_bound
        assert got.robot_obs_mean is None

    def test_fallback_parser_equals_yaml(self):
        """Without PyYAML the port's parser reads the multi-line mean and std
        the generator writes (the JAX fallback reads neither)."""
        import yaml

        want = yaml.safe_load(STATS_YAML)
        got = parse_simple_yaml(STATS_YAML)
        assert got["act_min_bound"] == want["act_min_bound"]
        assert got["act_max_bound"] == want["act_max_bound"]
        assert got["robot_obs"] == [{k: v for k, v in want["robot_obs"][0].items() if k != "_target_"}]

    @pytest.mark.parametrize("split", ["training", "validation"])
    @pytest.mark.parametrize("load_lang_embeddings", [True, False])
    def test_episode_indices_equal_jax(self, calvin_dir, split, load_lang_embeddings):
        from hulc2_tpu.data import episode_index as jei

        d = calvin_dir / split
        got = [ei.build_vision_index(d, split, 10, 16),
               ei.build_lang_index(d, split, 10, 16, "lang_annotations",
                                   load_lang_embeddings=load_lang_embeddings)]
        want = [jei.build_vision_index(d, split, 10, 16),
                jei.build_lang_index(d, split, 10, 16, "lang_annotations",
                                     load_lang_embeddings=load_lang_embeddings)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.episode_lookup, w.episode_lookup)
            assert g.validation == w.validation and g.with_lang == w.with_lang
            if w.with_lang:
                np.testing.assert_array_equal(g.lang_lookup, w.lang_lookup)
                np.testing.assert_array_equal(g.lang_ann, w.lang_ann)
                assert g.lang_tasks == w.lang_tasks
            rng_g, rng_w = np.random.default_rng(0), np.random.default_rng(0)
            for idx in range(len(w)):
                assert g.window_size(idx, rng_g) == w.window_size(idx, rng_w)
                assert g.max_window(idx) == w.max_window(idx)
                assert g.use_for_aux_lang_loss(idx) == w.use_for_aux_lang_loss(idx)

    def test_data_percent_equals_jax(self, calvin_dir):
        from hulc2_tpu.data import episode_index as jei

        ids = ei.load_ep_start_end_ids(calvin_dir / "training", "training")
        for pct in (0.3, 0.7, 1.0):
            np.testing.assert_array_equal(ei.apply_data_percent(ids, pct),
                                          jei.apply_data_percent(ids, pct))

    def test_frame_stores_equal_jax(self, calvin_dir):
        from hulc2_tpu.data.frame_store import NpzFrameStore as JaxNpz
        from hulc2_tpu.data.frame_store import RamFrameStore as JaxRam

        d = calvin_dir / "training"
        ids = ei.load_ep_start_end_ids(d, "training")
        npz, ram = NpzFrameStore(d, KEYS), RamFrameStore(NpzFrameStore(d, KEYS), ids, KEYS)
        jram = JaxRam(JaxNpz(d, KEYS), ids, KEYS)
        assert ram.id_to_row == jram.id_to_row
        for k in KEYS:
            np.testing.assert_array_equal(ram.arrays[k], jram.arrays[k])
        for start in (0, 37, 110):
            a, b = npz.load_window(start, 12), ram.load_window(start, 12)
            for k in KEYS:
                np.testing.assert_array_equal(a[k], b[k])
        ram.drop_arrays(["rgb_static"])
        assert "rgb_static" not in ram.arrays
        # the shared-memory cache holds the same frames (its own test file
        # covers attaching, cleanup and stale segments)
        shm = RamFrameStore(npz, ids, KEYS, use_shm=True, shm_tag=f"port_data_{os.getpid()}")
        try:
            for k in KEYS:
                np.testing.assert_array_equal(shm.arrays[k], jram.arrays[k])
        finally:
            shm.cleanup()

    @pytest.mark.parametrize("load_lang_embeddings", [True, False])
    def test_window_datasets_equal_jax(self, calvin_dir, load_lang_embeddings):
        """``write_into`` and ``__getitem__`` of every dataset of both splits,
        array for array, dtypes included."""
        got = _port_dm(calvin_dir, load_lang_embeddings=load_lang_embeddings)
        want = _jax_dm(calvin_dir, load_lang_embeddings=load_lang_embeddings)
        assert {k: len(v) for k, v in got.datasets.items()} == \
            {k: len(v) for k, v in want.datasets.items()}
        for name, wds in want.datasets.items():
            gds = got.datasets[name]
            specs = wds.out_specs(4)
            assert gds.out_specs(4) == specs
            bufs = [{k: np.zeros(s, t) for k, (s, t) in specs.items()} for _ in range(2)]
            for row, idx in enumerate(range(0, len(wds), max(1, len(wds) // 4))[:4]):
                gds.write_into(idx, bufs[0], row, epoch=3)
                wds.write_into(idx, bufs[1], row, epoch=3)
                g_item, w_item = gds[idx], wds[idx]
                assert set(g_item) == set(w_item)
                for k, w in w_item.items():
                    assert np.asarray(g_item[k]).dtype == np.asarray(w).dtype, (name, k)
                    np.testing.assert_array_equal(g_item[k], w, err_msg=f"{name} {k}")
            for k in specs:
                np.testing.assert_array_equal(bufs[0][k], bufs[1][k], err_msg=f"{name} {k}")
        assert got.steps_per_epoch() == want.steps_per_epoch()
        for split in ("training", "validation"):
            np.testing.assert_array_equal(got.stats[split].robot_obs_std,
                                          want.stats[split].robot_obs_std)

    def test_annotation_bank_and_hash_embed_equal_jax(self):
        from hulc2_tpu.tools import annotations as jann
        from hulc2_tpu.tools.auto_lang_annotator import hash_embed as jax_hash_embed
        from hulc2_torch.tools import annotations as ann
        from hulc2_torch.tools.auto_lang_annotator import hash_embed

        assert ann.ANNOTATION_BANK == jann.ANNOTATION_BANK
        assert ann.VALIDATION_BANK == jann.VALIDATION_BANK
        for task in ann.ANNOTATION_BANK:
            assert ann.heldout_annotations(task) == jann.heldout_annotations(task)
            rg, rw = np.random.default_rng(5), np.random.default_rng(5)
            for holdout in (0, 4):
                assert ([ann.sample_annotation(task, rg, holdout_k=holdout) for _ in range(6)]
                        == [jann.sample_annotation(task, rw, holdout_k=holdout) for _ in range(6)])
        sentences = ["open the drawer", "turn on the led", "open the drawer."]
        np.testing.assert_array_equal(hash_embed(sentences), jax_hash_embed(sentences))

    def test_kl_schedules_equal_jax(self):
        from hulc2_tpu.train.kl_schedule import make_kl_schedule as jax_make
        from hulc2_torch.train.kl_schedule import make_kl_schedule

        for cfg in ({"kind": "constant", "kl_beta": 0.01},
                    {"kind": "linear", "kl_beta": 0.01, "start_epoch": 2, "end_epoch": 7},
                    {"kind": "sigmoid", "kl_beta": 0.02, "start_epoch": 1, "end_epoch": 9,
                     "max_kl_beta": 0.05}):
            assert [make_kl_schedule(cfg)(e) for e in range(12)] == \
                [jax_make(cfg)(e) for e in range(12)]


def test_expert_dataset_equals_jax(tmp_path):
    """Both generators from one seed (1 training episode of 3 tasks, 1
    validation episode of 2, token annotations): every file equal."""
    from hulc2_tpu.tools.make_expert_dataset import make_expert_dataset as jax_make

    kw = dict(episodes=1, tasks_per_episode=3, val_episodes=1, val_tasks_per_episode=2,
              seed=0, lang_tokens=True, holdout_paraphrases=4)
    make_expert_dataset(tmp_path / "port", **kw)
    jax_make(tmp_path / "jax", **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    assert sum(f.suffix == ".npz" for f in files) > 100
    for f in files:
        got, want = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.suffix == ".npz":
            with np.load(got) as g, np.load(want) as w:
                assert g.files == w.files
                for k in w.files:
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{f} {k}")
        elif f.name == "ep_start_end_ids.npy":
            np.testing.assert_array_equal(np.load(got), np.load(want))
        elif f.name in ("auto_lang_ann.npy", "embeddings.npy"):
            g, w = (np.load(p, allow_pickle=True).item() for p in (got, want))
            if f.name == "auto_lang_ann.npy":
                assert g["info"] == w["info"]
                assert g["language"]["ann"] == w["language"]["ann"]
                assert g["language"]["task"] == w["language"]["task"]
                np.testing.assert_array_equal(g["language"]["emb"], w["language"]["emb"])
            else:
                assert g.keys() == w.keys()
                for t in w:
                    assert g[t]["ann"] == w[t]["ann"]
                    np.testing.assert_array_equal(g[t]["emb"], w[t]["emb"])
        else:
            assert got.read_bytes() == want.read_bytes(), f


def _generate_with_16_frame_chunks(tmp_path, monkeypatch, cpus: int) -> list:
    """Generate one small dataset with 256-frame chunks (too few for a pool)
    and again with 16-frame chunks, ``cpus`` CPUs seen; check every file is
    byte-equal; return the worker counts of the pools started."""
    from hulc2_torch.tools import make_expert_dataset as med

    started = []
    real_pool = med._RenderPool
    monkeypatch.setattr(med, "_RenderPool", lambda workers: started.append(workers) or
                        real_pool(workers))
    monkeypatch.setattr(os, "cpu_count", lambda: cpus)
    kw = dict(episodes=3, tasks_per_episode=2, val_episodes=1, val_tasks_per_episode=1,
              static_hw=32, gripper_hw=32, seed=0, lang_tokens=True, holdout_paraphrases=4)
    make_expert_dataset(tmp_path / "serial", **kw)
    assert started == []
    monkeypatch.setattr(med._FrameWriter, "CHUNK", 16)
    make_expert_dataset(tmp_path / "chunks", **kw)
    files = sorted(p.relative_to(tmp_path / "serial") for p in (tmp_path / "serial").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "chunks")
                           for p in (tmp_path / "chunks").rglob("*") if p.is_file())
    assert sum(f.suffix == ".npz" for f in files) > (med._FrameWriter.POOL_MIN_CHUNKS + 2) * 16
    for f in files:
        assert (tmp_path / "chunks" / f).read_bytes() == (tmp_path / "serial" / f).read_bytes(), f
    return started


def test_expert_dataset_render_workers_write_the_same_files(tmp_path, monkeypatch):
    """Once an episode shows ``POOL_MIN_CHUNKS`` chunks of frames left in its
    split, a pool of one worker process for every CPU but the expert's
    renders and saves them while the expert runs on (how the round-5 run
    generates 263k frames in minutes); the files are the ones the generator
    writes in one process, byte for byte. A split of fewer chunks starts no
    pool."""
    assert _generate_with_16_frame_chunks(tmp_path, monkeypatch, cpus=3) == [2]


def test_expert_dataset_stays_in_process_on_one_cpu(tmp_path, monkeypatch):
    """With one CPU the generator starts no pool, however many chunks are
    left, and writes the same files."""
    assert _generate_with_16_frame_chunks(tmp_path, monkeypatch, cpus=1) == []


def test_unaligned_lang_windows_equal_jax_before_alignment(tmp_path, monkeypatch):
    """``--unaligned-lang-windows`` annotates as the JAX package did before it
    aligned its windows to end at the task's completion, which is how the
    round-5 flagship dataset was annotated (its 10,065 windows; the aligned
    annotator finds 3,124 in the same frames): the port's annotations equal
    JAX's ``annotate_dataset`` with ``detect_task_windows(align_end=False)``,
    and there are more of them than aligned ones."""
    import functools

    from hulc2_tpu.tools import auto_lang_annotator as jann

    kw = dict(episodes=1, tasks_per_episode=8, val_episodes=0, seed=0, lang_tokens=True,
              holdout_paraphrases=4)
    make_expert_dataset(tmp_path, align_lang_windows=False, **kw)
    d = tmp_path / "training"
    monkeypatch.setattr(jann, "detect_task_windows",
                        functools.partial(jann.detect_task_windows, align_end=False))
    want = jann.annotate_dataset(d, lang_folder="jax", window=64, stride=8, embed_fn="tokens",
                                 seed=0, holdout_k=4)
    got = np.load(d / "lang_annotations" / "auto_lang_ann.npy", allow_pickle=True).item()
    assert got["info"] == want["info"]
    assert got["language"]["ann"] == want["language"]["ann"]
    assert got["language"]["task"] == want["language"]["task"]
    np.testing.assert_array_equal(got["language"]["emb"], want["language"]["emb"])
    monkeypatch.undo()
    aligned = jann.annotate_dataset(d, lang_folder="aligned", window=64, stride=8,
                                    embed_fn="tokens", seed=0, holdout_k=4)
    assert len(got["language"]["ann"]) > len(aligned["language"]["ann"]) > 0


def test_device_gather_equals_jax_fused_loader(calvin_dir):
    """The device-store loader (here on the CPU) against the JAX package's
    host FusedBatchLoader over two epochs: every key, dtype and value; then
    the same batches through the prefetcher as tensors."""
    from hulc2_tpu.data.loader import FusedBatchLoader

    dm = _port_dm(calvin_dir)
    loader = dm.fused_train_iter()
    assert "rgb_static" not in dm.datasets["vis_training"].store.arrays  # host copy dropped
    assert dm.device_store.nbytes == 2 * (61 + 56) * 16 * 16 * 3
    jdm = _jax_dm(calvin_dir)
    ref = FusedBatchLoader(jdm.datasets["vis_training"], jdm.datasets["lang_training"],
                           batch_size_vis=3, batch_size_lang=2, shuffle=True, seed=7, num_threads=1)
    assert len(loader) == len(ref) == dm.steps_per_epoch()
    for epoch in range(2):
        n = 0
        for got, want in zip(loader, ref):
            assert set(got) == set(want)
            for k, w in want.items():
                g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=f"epoch {epoch} {k}")
            n += 1
        assert n == len(ref)
    loader.epoch = 1
    ref.epoch = 1
    for got, want in zip(DevicePrefetcher(loader, "cpu"), ref):
        for k, w in want.items():
            assert isinstance(got[k], torch.Tensor)
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_device_gather_equals_host_plan(calvin_dir):
    """The same check against the port's own host plan (``write_into``): the
    reference the card's test uses, where JAX is absent."""
    host = _port_dm(calvin_dir)
    dm = _port_dm(calvin_dir)
    loader = dm.fused_train_iter()
    for epoch in range(2):
        for got, want in zip(loader, host_fused_batches(host, epoch)):
            for k, w in want.items():
                g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
                np.testing.assert_array_equal(g, w, err_msg=f"epoch {epoch} {k}")


def test_datamodule_refuses_unported_paths(calvin_dir):
    """The device store refuses frame skipping and one modality, and so does
    the process loader (ported since) one modality, as JAX's; an unknown
    ``loader_isolation`` raises."""
    for changes, err in (({"frame_skip": {"strategy": "random"}}, NotImplementedError),
                         ({"datasets": {"vis": True, "lang": False}}, NotImplementedError),
                         ({"loader_isolation": "process", "device_store": False,
                           "datasets": {"vis": True, "lang": False}}, NotImplementedError),
                         ({"loader_isolation": "thread"}, ValueError)):
        cfg = dm_cfg(calvin_dir)
        cfg.update(changes)
        with pytest.raises(err):
            Hulc2DataModule(cfg, device="cpu")


def test_val_iter_equals_jax(calvin_dir):
    got, want = _port_dm(calvin_dir), _jax_dm(calvin_dir)
    n = 0
    for g, w in zip(got.val_iter(), want.val_iter()):
        for m in ("vis", "lang"):
            assert set(g[m]) == set(w[m])
            for k in w[m]:
                np.testing.assert_array_equal(g[m][k], w[m][k], err_msg=f"{m} {k}")
        n += 1
    assert n == got.val_batches() > 0


class TestPrefetcher:
    def test_raises_the_producers_error(self):
        def batches():
            yield {"x": np.zeros(3, np.float32)}
            raise KeyError("boom")

        it = DevicePrefetcher(batches(), "cpu")
        assert next(it)["x"].shape == (3,)
        with pytest.raises(KeyError, match="boom"):
            next(it)
        it.close()
        assert not it.thread.is_alive()

    def test_close_stops_an_endless_producer(self):
        produced = []

        def endless():
            while True:
                produced.append(1)
                yield {"x": np.arange(4)}

        it = DevicePrefetcher(endless(), "cpu", prefetch=2)
        for _ in range(5):
            np.testing.assert_array_equal(next(it)["x"].numpy(), np.arange(4))
        it.close(timeout=10)
        assert not it.thread.is_alive()
        assert len(produced) <= 5 + 4
        assert it.wait_s >= 0.0

    def test_order_kept_under_thread_switches(self):
        import sys

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            it = DevicePrefetcher(({"i": np.asarray([i])} for i in range(200)), "cpu", prefetch=3)
            got = [int(b["i"][0]) for b in it]
            it.close(timeout=10)
        finally:
            sys.setswitchinterval(old)
        assert got == list(range(200))
        assert threading.active_count() < 50


@pytest.mark.parametrize("flags", [
    {"normalize": True, "normalize_robot_orientation": True},
    {"normalize": True, "normalize_robot_orientation": False},
    {"normalize": False, "normalize_robot_orientation": True},
])
def test_process_proprio_with_stats_equals_jax(calvin_dir, flags):
    """Normalized with statistics.yaml's robot_obs mean and std, then sliced:
    atol 1e-6 against the JAX function; the stats go to the device once."""
    from hulc2_tpu.data.device_transforms import process_proprio as jprocess
    from hulc2_tpu.data.statistics import load_statistics as jax_load

    cfg = {"keep_indices": [[0, 7], [14, 15]], "robot_orientation_idx": [3, 6], **flags}
    x = np.random.default_rng(2).standard_normal((3, 5, 15)).astype(np.float32)
    stats = load_statistics(calvin_dir / "training")
    want = np.asarray(jprocess(jnp.asarray(x), jax_load(calvin_dir / "training"), cfg))
    cache = {}
    got = process_proprio(torch.from_numpy(x), cfg, stats, cache).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert list(cache) == [torch.device("cpu")]
    # without statistics the normalization is the identity
    np.testing.assert_array_equal(process_proprio(torch.from_numpy(x), cfg, DatasetStatistics()).numpy(),
                                  np.concatenate([x[..., 0:7], x[..., 14:15]], -1))
