"""DataModule: indices, frame stores, datasets and loaders of both splits
(``hulc2_tpu/data/datamodule.py``).

Two training paths, as in the JAX package:
- ``datamodule.device_store=true`` (the flagship's): the training split is
  read into a RAM cache, its image keys are uploaded once to the card
  (``data/device_store.py``) and the host copies of them are dropped;
- ``device_store: false`` (``cfg_low_level``'s default): every training
  batch is assembled on the host by ``loader.FusedBatchLoader`` (pinned
  buffers from a ring when the device is the card), from the npz files
  through the native loader (``frame_store.NpzFrameStore``) or, with
  ``use_shm_cache`` (``training --shm-cache``), from a shared-memory cache of
  the split (``RamFrameStore(use_shm=True)``).
The validation split is always held in a RAM cache: the JAX package reads
its windows frame by frame from the npz files, which gives the same windows
at one file read per frame of every window; the cache reads each frame
once. Each split's ``statistics.yaml`` is parsed into ``stats``.
``datamodule.frame_skip`` (``random`` or ``diff``) subsamples the windows of
both splits (the device store refuses it); ``datamodule.datasets`` with one
modality off (``vision_only``, ``lang_only``) builds that modality's
datasets only, and its training batches come from the per-modality
``BatchLoader`` as {modality: batch}, as in JAX (the device store refuses
it, as JAX's does). ``datamodule.loader_isolation=process`` assembles the
host path's training batches in a subprocess (``data/process_loader.py``),
as JAX routes it (``hulc2_tpu/data/datamodule.py:138-154``): before the
device store, which it overrides, and refused with one modality. In a
data-parallel run (``process_index`` of ``process_count``) every loader of
both splits takes this process's stride of its epoch's order
(``loader.process_shard``), and an epoch is ``process_count`` times
shorter.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Iterator, Optional

from hulc2_torch.data import episode_index as ei
from hulc2_torch.data.device_store import DeviceFrameStore, DeviceGatherFusedLoader
from hulc2_torch.data.frame_skip import make_frame_skip
from hulc2_torch.data.frame_store import NpzFrameStore, RamFrameStore
from hulc2_torch.data.loader import BatchLoader, FusedBatchLoader, ModalityLoader, zip_modalities
from hulc2_torch.data.statistics import DatasetStatistics, load_statistics
from hulc2_torch.data.window_dataset import WindowDataset
from hulc2_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

MODALITIES = ("vis", "lang")


class Hulc2DataModule:
    def __init__(self, dm_cfg: dict, seed: int = 42, device=None, use_shm_cache: bool = False,
                 process_index: int = 0, process_count: int = 1):
        self.cfg = dm_cfg
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self.device = resolve_device(device)
        self.root = Path(dm_cfg["root_data_dir"])
        self.use_shm_cache = use_shm_cache
        self.isolation = dm_cfg.get("loader_isolation", "none")
        if self.isolation not in ("none", "process"):
            raise ValueError(f"unknown datamodule.loader_isolation {self.isolation!r}")
        ds = dm_cfg.get("datasets") or {}
        self.modalities = tuple(m for m in MODALITIES if ds.get(m, True))
        if not self.modalities:
            raise ValueError("datamodule.datasets disables every modality")
        if dm_cfg.get("frame_skip") and dm_cfg.get("device_store", False):
            raise NotImplementedError("the device-store gather does not support frame_skip")
        if len(self.modalities) == 1 and (dm_cfg.get("device_store", False)
                                          or self.isolation == "process"):
            raise NotImplementedError("the device store and the process loader need both "
                                      "modalities: a single-modality config trains through "
                                      "the per-modality loader")
        self.stats: Dict[str, DatasetStatistics] = {}
        self._stores: Dict[str, object] = {}
        self.datasets: Dict[str, WindowDataset] = {}
        self.device_store: Optional[DeviceFrameStore] = None
        self._train_loader = None

    def setup(self, splits=("training", "validation")) -> None:
        """The splits' statistics, frame stores and datasets (the process
        loader's child sets up the training split alone)."""
        obs = self.cfg["observation_space"]
        frame_keys = (list(obs["rgb_obs"]) + list(obs["depth_obs"]) + list(obs["state_obs"])
                      + list(obs["actions"]))
        if "robot_obs" not in frame_keys:
            frame_keys.append("robot_obs")
        host_train = not self.cfg.get("device_store", False) or self.isolation == "process"
        for split in splits:
            split_dir = self.root / split
            self.stats[split] = load_statistics(split_dir)
            npz = NpzFrameStore(split_dir, frame_keys)
            if split == "training" and host_train and not self.use_shm_cache:
                store = npz
            else:
                store = RamFrameStore(npz, ei.load_ep_start_end_ids(split_dir, split), frame_keys,
                                      use_shm=self.use_shm_cache and split == "training",
                                      num_workers=self.cfg.get("num_workers", 8))
            self._stores[split] = store
            indices = {}
            if "vis" in self.modalities:
                indices["vis"] = ei.build_vision_index(
                    split_dir, split, self.cfg["min_window_size"], self.cfg["max_window_size"],
                    self.cfg.get("data_percent", 1.0))
            if "lang" in self.modalities:
                indices["lang"] = ei.build_lang_index(
                    split_dir, split, self.cfg["min_window_size"], self.cfg["max_window_size"],
                    self.cfg["lang_folder"], self.cfg.get("skip_frames", 1),
                    self.cfg.get("data_percent", 1.0), self.cfg.get("aux_lang_loss_window", 8),
                    self.cfg.get("load_lang_embeddings", True))
            # both splits skip frames, so that their windows keep one shape
            fskip = make_frame_skip(self.cfg.get("frame_skip"))
            for key, index in indices.items():
                self.datasets[f"{key}_{split}"] = WindowDataset(
                    index, store, obs, pad=self.cfg.get("pad", True), seed=self.seed,
                    frame_skip=fskip)
        logger.info("datamodule: %s", {k: len(v) for k, v in self.datasets.items()})

    def _batch_size(self, key: str) -> int:
        return self.cfg.get(f"batch_size_{key}", self.cfg.get("batch_size", 32))

    def fused_train_iter(self):
        """The training loader, built on the first call. With the device
        store: the upload happens here, after which the RAM cache's image
        arrays are dropped (only the small keys are read per step), and the
        loader gathers on the device. Without: the host ``FusedBatchLoader``,
        its buffers pinned on the card, or with ``loader_isolation=process``
        the ``ProcessFusedLoader``. With one modality: its ``BatchLoader``
        (``ModalityLoader``)."""
        if self._train_loader is not None:
            return self._train_loader
        if len(self.modalities) == 1:
            (m,) = self.modalities
            self._train_loader = ModalityLoader(m, BatchLoader(
                self.datasets[f"{m}_training"], self._batch_size(m), shuffle=True, seed=self.seed,
                num_threads=self.cfg.get("num_workers", 4), **self._shard))
            return self._train_loader
        vis, lang = self.datasets["vis_training"], self.datasets["lang_training"]
        if self.isolation == "process":
            from hulc2_torch.data.process_loader import ProcessFusedLoader

            self._train_loader = ProcessFusedLoader(
                self.cfg, vis, lang, self._batch_size("vis"), self._batch_size("lang"),
                seed=self.seed, use_shm_cache=self.use_shm_cache,
                num_threads=self.cfg.get("num_workers", 4),
                pin_memory=self.device.type == "cuda", **self._shard)
            return self._train_loader
        if not self.cfg.get("device_store", False):
            self._train_loader = FusedBatchLoader(
                vis, lang, self._batch_size("vis"), self._batch_size("lang"), seed=self.seed,
                num_threads=self.cfg.get("num_workers", 4),
                pin_memory=self.device.type == "cuda", **self._shard)
            return self._train_loader
        obs = self.cfg["observation_space"]
        ram = self._stores["training"]
        self.device_store = DeviceFrameStore(
            ram, list(obs["rgb_obs"]) + list(obs["depth_obs"]), self.device)
        logger.info("device frame store: %d bytes resident, uploaded in %.2f s",
                    self.device_store.nbytes, self.device_store.upload_s)
        ram.drop_arrays(self.device_store.image_keys)
        self._train_loader = DeviceGatherFusedLoader(
            vis, lang, self.device_store, self._batch_size("vis"), self._batch_size("lang"),
            seed=self.seed, **self._shard)
        return self._train_loader

    def close(self) -> None:
        """Stop the process loader, close the shared-memory cache of the
        training split and unlink it if this datamodule made it (otherwise
        that happens at exit)."""
        close = getattr(self._train_loader, "close", None)
        if close is not None:
            close()
        if self.use_shm_cache and "training" in self._stores:
            self._stores["training"].cleanup()

    def val_iter(self) -> Iterator[Dict]:
        """{"vis": ..., "lang": ...} numpy batches of the validation split (of
        the configured modalities), in index order unless ``shuffle_val``."""
        loaders = [BatchLoader(self.datasets[f"{m}_validation"], self._batch_size(m),
                               shuffle=self.cfg.get("shuffle_val", False), seed=self.seed,
                               num_threads=self.cfg.get("num_workers", 4), **self._shard)
                   for m in self.modalities]
        return zip_modalities(self.modalities, *loaders)

    @property
    def _shard(self) -> dict:
        return {"process_index": self.process_index, "process_count": self.process_count}

    def steps_per_epoch(self) -> int:
        return min(len(self.datasets[f"{m}_training"]) // self.process_count // self._batch_size(m)
                   for m in self.modalities)

    def val_batches(self) -> int:
        return min(len(self.datasets[f"{m}_validation"]) // self.process_count
                   // self._batch_size(m) for m in self.modalities)
