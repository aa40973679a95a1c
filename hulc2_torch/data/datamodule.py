"""DataModule: indices, frame stores, datasets and loaders of both splits
(``hulc2_tpu/data/datamodule.py``).

The port's counterpart of the device-store path the flagship trains on
(``datamodule.device_store=true``): each split is read into a RAM cache; the
training split's image keys are uploaded once to the card
(``data/device_store.py``) and the host copies of them are dropped. The JAX
package reads the validation windows frame by frame from the npz files,
which gives the same windows at one file read per frame of every window;
the cache reads each frame once. Each split's
``statistics.yaml`` is parsed into ``stats``. Not ported, and refused: the
host-assembled training path without the device store, the subprocess
loader, the shared-memory cache, within-window frame skipping and
single-modality datasets.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Iterator, Optional

from hulc2_torch.data import episode_index as ei
from hulc2_torch.data.device_store import DeviceFrameStore, DeviceGatherFusedLoader
from hulc2_torch.data.frame_store import NpzFrameStore, RamFrameStore
from hulc2_torch.data.loader import BatchLoader, zip_modalities
from hulc2_torch.data.statistics import DatasetStatistics, load_statistics
from hulc2_torch.data.window_dataset import WindowDataset
from hulc2_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

MODALITIES = ("vis", "lang")


class Hulc2DataModule:
    def __init__(self, dm_cfg: dict, seed: int = 42, device=None):
        self.cfg = dm_cfg
        self.seed = seed
        self.device = resolve_device(device)
        self.root = Path(dm_cfg["root_data_dir"])
        if not dm_cfg.get("device_store", False):
            raise NotImplementedError("only the device-store training path "
                                      "(datamodule.device_store=true) is ported")
        if dm_cfg.get("frame_skip") is not None:
            raise NotImplementedError("datamodule.frame_skip is not ported")
        if dm_cfg.get("loader_isolation", "none") != "none":
            raise NotImplementedError("datamodule.loader_isolation is not ported")
        if any(not on for on in (dm_cfg.get("datasets") or {}).values()):
            raise NotImplementedError("single-modality datasets are not ported")
        self.stats: Dict[str, DatasetStatistics] = {}
        self._stores: Dict[str, object] = {}
        self.datasets: Dict[str, WindowDataset] = {}
        self.device_store: Optional[DeviceFrameStore] = None
        self._device_loader: Optional[DeviceGatherFusedLoader] = None

    def setup(self) -> None:
        obs = self.cfg["observation_space"]
        frame_keys = (list(obs["rgb_obs"]) + list(obs["depth_obs"]) + list(obs["state_obs"])
                      + list(obs["actions"]))
        if "robot_obs" not in frame_keys:
            frame_keys.append("robot_obs")
        for split in ("training", "validation"):
            split_dir = self.root / split
            self.stats[split] = load_statistics(split_dir)
            store = RamFrameStore(NpzFrameStore(split_dir, frame_keys),
                                  ei.load_ep_start_end_ids(split_dir, split), frame_keys,
                                  num_workers=self.cfg.get("num_workers", 8))
            self._stores[split] = store
            indices = {
                "vis": ei.build_vision_index(
                    split_dir, split, self.cfg["min_window_size"], self.cfg["max_window_size"],
                    self.cfg.get("data_percent", 1.0)),
                "lang": ei.build_lang_index(
                    split_dir, split, self.cfg["min_window_size"], self.cfg["max_window_size"],
                    self.cfg["lang_folder"], self.cfg.get("skip_frames", 1),
                    self.cfg.get("data_percent", 1.0), self.cfg.get("aux_lang_loss_window", 8),
                    self.cfg.get("load_lang_embeddings", True)),
            }
            for key, index in indices.items():
                self.datasets[f"{key}_{split}"] = WindowDataset(
                    index, store, obs, pad=self.cfg.get("pad", True), seed=self.seed)
        logger.info("datamodule: %s", {k: len(v) for k, v in self.datasets.items()})

    def _batch_size(self, key: str) -> int:
        return self.cfg.get(f"batch_size_{key}", self.cfg.get("batch_size", 32))

    def fused_train_iter(self) -> DeviceGatherFusedLoader:
        """The training loader over the device-resident frame store, built on
        the first call: the upload happens there, after which the RAM cache's
        image arrays are dropped (only the small keys are read per step)."""
        if self._device_loader is None:
            obs = self.cfg["observation_space"]
            ram = self._stores["training"]
            self.device_store = DeviceFrameStore(
                ram, list(obs["rgb_obs"]) + list(obs["depth_obs"]), self.device)
            logger.info("device frame store: %d bytes resident, uploaded in %.2f s",
                        self.device_store.nbytes, self.device_store.upload_s)
            ram.drop_arrays(self.device_store.image_keys)
            self._device_loader = DeviceGatherFusedLoader(
                self.datasets["vis_training"], self.datasets["lang_training"],
                self.device_store, self._batch_size("vis"), self._batch_size("lang"),
                seed=self.seed)
        return self._device_loader

    def val_iter(self) -> Iterator[Dict]:
        """{"vis": ..., "lang": ...} numpy batches of the validation split, in
        index order unless ``shuffle_val``."""
        loaders = [BatchLoader(self.datasets[f"{m}_validation"], self._batch_size(m),
                               shuffle=self.cfg.get("shuffle_val", False), seed=self.seed,
                               num_threads=self.cfg.get("num_workers", 4))
                   for m in MODALITIES]
        return zip_modalities(MODALITIES, *loaders)

    def steps_per_epoch(self) -> int:
        return min(len(self.datasets[f"{m}_training"]) // self._batch_size(m) for m in MODALITIES)

    def val_batches(self) -> int:
        return min(len(self.datasets[f"{m}_validation"]) // self._batch_size(m) for m in MODALITIES)
