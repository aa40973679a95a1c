"""Device-resident frame store: the training split's frames live on the card
(``hulc2_tpu/data/device_store.py``).

Windows overlap heavily (stride-1 sampling over play episodes), so streaming
pixel batches re-sends every frame about window-size times per epoch.
Instead each image key of the split is uploaded ONCE as one (N, H*W*C)
tensor in its stored dtype (uint8 RGB, float16 depth, which the transform
widens); per step the host computes only the window *plan* (frame-row
indices with pad-repeat semantics, plus the small keys: actions, proprio,
scene_obs when the observation space names it, language), and the (B, S)
gather is one ``index_select`` per key on the device. Frame skipping is
refused, as JAX's gather refuses it (``hulc2_tpu/data/device_store.py:104-105``).

Sampling is bit-identical to the JAX package's ``loader.FusedBatchLoader``
and ``DeviceGatherFusedLoader``: the same epoch orders from
``default_rng((seed, epoch + 1, 0|1))``, the same per-window generator
``default_rng((dataset seed, epoch, idx))``, the same padding (observations
repeat the last frame, relative actions zero-pad all but the gripper dim).
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from hulc2_torch.core import trace
from hulc2_torch.data.frame_store import RamFrameStore
from hulc2_torch.data.loader import fused_orders
from hulc2_torch.data.window_dataset import WindowDataset

logger = logging.getLogger(__name__)


class DeviceFrameStore:
    """Per-key flat frame rows on ``device``, indexed by frame row.

    Built from a ``RamFrameStore`` (one contiguous (N, ...) array per key);
    ``gather`` reshapes the gathered rows to (B, S, H, W, C)."""

    def __init__(self, ram_store: RamFrameStore, image_keys: Sequence[str], device):
        self.device = torch.device(device)
        self.id_to_row = ram_store.id_to_row
        self.image_keys = [k for k in image_keys if k in ram_store.arrays]
        self.frame_shapes = {k: tuple(ram_store.arrays[k].shape[1:]) for k in self.image_keys}
        t0 = time.perf_counter()
        self.arrays: Dict[str, torch.Tensor] = {}
        for k in self.image_keys:
            a = np.ascontiguousarray(ram_store.arrays[k])
            self.arrays[k] = torch.from_numpy(a.reshape(a.shape[0], -1)).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_s = time.perf_counter() - t0
        self.nbytes = sum(t.numel() * t.element_size() for t in self.arrays.values())

    def gather(self, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        """rows (B, S) int32 -> {key: (B, S, H, W, C) tensor on the device},
        enqueued on the current stream. On the card the row indices go up
        through pinned memory without waiting."""
        idx = torch.from_numpy(np.ascontiguousarray(rows).reshape(-1))
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return {k: a.index_select(0, idx).reshape(*rows.shape, *self.frame_shapes[k])
                for k, a in self.arrays.items()}


class DeviceGatherFusedLoader:
    """Fused [vis; lang] batches with the images gathered on the device.

    Each batch holds the image keys as device tensors (B, S, H, W, C) and the
    small keys as host numpy arrays: ``robot_obs_raw``, ``actions`` and
    [``scene_obs``] for all rows, ``lang``, ``use_for_aux_lang_loss`` and ``lang_task_id`` for
    the lang rows. ``DevicePrefetcher`` copies the small keys up. In a
    data-parallel run each process takes its ``process_shard`` of both orders
    (``hulc2_tpu/data/device_store.py:121-134``). While tracing is on
    (``core/trace``), a batch's host plan is the span ``store.plan_rows`` and
    its gather (the index's pinning and upload, the ``index_select``
    launches) ``store.gather``."""

    def __init__(self, vis_dataset: WindowDataset, lang_dataset: WindowDataset,
                 dev_store: DeviceFrameStore, batch_size_vis: int, batch_size_lang: int,
                 seed: int = 0, process_index: int = 0, process_count: int = 1):
        if vis_dataset.frame_skip is not None or lang_dataset.frame_skip is not None:
            raise NotImplementedError("the device-store gather does not support frame_skip")
        if vis_dataset.padded_size != lang_dataset.padded_size:
            raise ValueError("vis and lang windows must pad to one size")
        self.vis = vis_dataset
        self.lang = lang_dataset
        self.store = dev_store
        self.bv = batch_size_vis
        self.bl = batch_size_lang
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.S = vis_dataset.padded_size

    def __len__(self) -> int:
        return min(len(self.vis) // self.process_count // self.bv,
                   len(self.lang) // self.process_count // self.bl)

    def _orders(self, epoch: int):
        return fused_orders(self.seed, epoch, len(self.vis), len(self.lang), self.process_index,
                            self.process_count)

    def _plan_rows(self, ds: WindowDataset, idxs, epoch: int, rows: np.ndarray, row0: int,
                   out: Dict[str, np.ndarray]) -> None:
        """Fill ``rows[row0 + j]`` with pad-repeat frame-row indices and the
        small keys for each sample: the host half of ``write_into``."""
        index = ds.index
        ram = ds.store  # RamFrameStore: flat arrays + id_to_row
        arange = np.arange(self.S)
        for j, idx in enumerate(idxs):
            idx = int(idx)
            rng = np.random.default_rng((ds.seed, epoch, idx))
            ws = index.window_size(idx, rng)
            start = int(index.episode_lookup[idx])
            r0 = self.store.id_to_row[start]
            r = row0 + j
            rows[r] = r0 + np.minimum(arange, ws - 1)  # pad = repeat the last frame
            for key, small in (("robot_obs", "robot_obs_raw"), ("scene_obs", "scene_obs")):
                if small in out:
                    obs = ram.arrays[key][r0 : r0 + ws]
                    dst = out[small][r]
                    dst[:ws] = obs
                    dst[ws:] = obs[-1]
            acts = ram.arrays[ds.action_key][r0 : r0 + ws]
            dst = out["actions"][r]
            dst[:ws] = acts
            if ds.relative_actions:  # zero-pad rel dims, repeat the gripper
                dst[ws:] = 0.0
                dst[ws:, -1] = acts[-1, -1]
            else:
                dst[ws:] = acts[-1]
            if index.with_lang:
                ann_row = int(index.lang_lookup[idx])
                out["lang"][r - self.bv] = ds._lang_value(ann_row)
                out["use_for_aux_lang_loss"][r - self.bv] = index.use_for_aux_lang_loss(idx)
                out["lang_task_id"][r - self.bv] = ds._lang_task_id(ann_row)

    def _assemble(self, vis_idxs, lang_idxs, epoch: int) -> Dict[str, object]:
        b = self.bv + self.bl
        ram = self.vis.store
        lang0 = self.lang._lang_value(0)
        rows = np.empty((b, self.S), np.int32)
        small: Dict[str, np.ndarray] = {
            "robot_obs_raw": np.empty((b, self.S, ram.arrays["robot_obs"].shape[-1]), np.float32),
            "actions": np.empty((b, self.S, ram.arrays[self.vis.action_key].shape[-1]), np.float32),
            "lang": np.empty((self.bl, lang0.shape[-1]), lang0.dtype),
            "use_for_aux_lang_loss": np.empty((self.bl,), np.bool_),
            "lang_task_id": np.empty((self.bl,), np.int32),
        }
        if self.vis.with_scene:
            small["scene_obs"] = np.empty((b, self.S, ram.arrays["scene_obs"].shape[-1]),
                                          np.float32)
        with trace.span("store.plan_rows"):
            self._plan_rows(self.vis, vis_idxs, epoch, rows, 0, small)
            self._plan_rows(self.lang, lang_idxs, epoch, rows, self.bv, small)
        with trace.span("store.gather"):
            batch: Dict[str, object] = dict(self.store.gather(rows))
        batch.update(small)
        return batch

    def __iter__(self) -> Iterator[Dict[str, object]]:
        epoch = self.epoch
        self.epoch += 1
        # the JAX loaders draw the epoch's order after advancing the counter:
        # the order comes from epoch + 1, the window sizes from epoch
        ov, ol = self._orders(self.epoch)
        for b in range(len(self)):
            yield self._assemble(ov[b * self.bv : (b + 1) * self.bv],
                                 ol[b * self.bl : (b + 1) * self.bl], epoch)


def host_fused_batches(vis: WindowDataset, lang: WindowDataset, batch_size_vis: int,
                       batch_size_lang: int, seed: int, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
    """The plain version of ``DeviceGatherFusedLoader``'s epoch ``epoch``: the
    same fused batches assembled on the host by the datasets' ``write_into``
    from their frame stores (the JAX package's ``FusedBatchLoader`` plan,
    single-threaded). It reads the RAM cache's image arrays, so it needs
    datasets whose store has not given them up to a device upload."""
    bv, bl = batch_size_vis, batch_size_lang
    specs = vis.out_specs(bv + bl)
    lang_specs = lang.out_specs(bv + bl)
    lang_only = [k for k in lang_specs if k not in specs]
    for k in lang_only:
        shape, dtype = lang_specs[k]
        specs[k] = ((bl, *shape[1:]), dtype)
    ov, ol = fused_orders(seed, epoch + 1, len(vis), len(lang))
    for b in range(min(len(vis) // bv, len(lang) // bl)):
        out = {k: np.empty(shape, dtype) for k, (shape, dtype) in specs.items()}
        # lang rows follow the vis rows in the shared keys
        lang_out = {k: (v if k in lang_only else v[bv:]) for k, v in out.items()}
        for row, idx in enumerate(ov[b * bv:(b + 1) * bv]):
            vis.write_into(int(idx), out, row, epoch)
        for row, idx in enumerate(ol[b * bl:(b + 1) * bl]):
            lang.write_into(int(idx), lang_out, row, epoch)
        yield out
