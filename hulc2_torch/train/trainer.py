"""The trainer loop: epochs, validation, callbacks, checkpoints, auto-resume
(``hulc2_tpu/train/trainer.py``).

An explicit loop around the port's train and val steps, with

- auto-resume from the newest checkpoint in the run dir: model, optimizer
  and learning-rate schedule state and step; the run goes on at epoch ``step // epoch length``, where an
  epoch is ``steps_per_epoch`` steps or ``trainer.limit_train_batches``;
- the KL beta of each epoch from the KL schedule; the learning rate of each
  update from ``model.lr_scheduler`` over ``steps_per_epoch x
  training.max_epochs`` estimated updates, logged as ``lr``;
- a checkpoint at the next step edge after SIGTERM or SIGUSR1 (the
  timeout-and-resubmit contract of a cluster scheduler), validation skipped;
- per-epoch validation (``trainer.limit_val_batches``), then, as JAX orders
  them (``:190-233``), the plan recorders (one validation batch through
  ``make_plan_sampler`` for the t-SNE callback), the callbacks
  (``train/callback_factory.build_callbacks``: rollouts, videos, t-SNE),
  each in a ``try`` so that a failing one never costs the epoch's
  checkpoint, their own keys logged, and the checkpoint, kept by
  ``callbacks/checkpoint`` (every step, the newest k, or the best k by its
  monitor over ``val/<key>`` and the callbacks' keys); after SIGTERM or
  SIGUSR1 the callbacks are skipped;
- the sinks of ``logger``: metrics.jsonl, and tensorboard (``tb``) or
  wandb;
- data parallelism over the processes of a started process group
  (``parallel/mesh.py``, one process per rank under ``torchrun``): the
  policy in DDP, each rank on its shard of the datamodule's batches and the
  step's draws and batch-coupled losses over the global batch
  (``train/steps.make_train_step``); validation and the rollouts split over
  the ranks and their metrics reduced; only the main process logs and
  writes checkpoints, and every rank resumes from the same step;
- the training split's statistics in ``<run_dir>/statistics.json``, which
  the eval's agent normalises robot_obs with;
- ``trainer.limit_train_batches``, ``log_every_n_steps`` and ``max_steps``.

The batches come through ``DevicePrefetcher`` from the datamodule's training
loader: the device store's gather, or the host ``FusedBatchLoader``
(``datamodule.device_store=false``). Each log line carries the step's wall
time and the consumer's wait for the prefetcher (``prefetch_wait_ms``),
which tells a step held up by its loader from one held up by the device.

The random draws of step k (crop offsets, plan sample, dropout) come from a
generator seeded with a function of (seed, k), as the JAX step folds the
step into its root key, and the batches of epoch e follow the loader's
order for e: a resumed run takes the same batches and draws as an
uninterrupted one.
"""
from __future__ import annotations

import logging
import signal
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from hulc2_torch import kernels
from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config
from hulc2_torch.core.metrics import MetricsLogger, get_git_commit_hash, print_system_env_info
from hulc2_torch.data.device_transforms import make_batch_transform
from hulc2_torch.data.loader import DevicePrefetcher, to_device
from hulc2_torch.data.statistics import save_statistics
from hulc2_torch.models.build import build_policy_for
from hulc2_torch.models.hulc2 import Hulc2
from hulc2_torch.parallel import mesh as mesh_lib
from hulc2_torch.train.kl_schedule import make_kl_schedule
from hulc2_torch.train.optim import make_optimizer, make_scheduler, schedule_value
from hulc2_torch.train.steps import (aux_betas_from_loss_cfg, make_plan_sampler, make_train_step,
                                     make_val_step, mean_over_ranks)
from hulc2_torch.utils.device import resolve_device, set_precision_flags

logger = logging.getLogger(__name__)

TRAIN_STREAM, VAL_STREAM, PLAN_STREAM = 0, 1, 2


def step_seed(seed: int, stream: int, k: int) -> int:
    """A 63-bit seed for draw k of ``stream`` (train steps, val batches)."""
    a, b = np.random.SeedSequence([seed, stream, k]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


@dataclass
class FitResult:
    model: Hulc2
    step: int
    resumed_from: Optional[int]
    history: List[Dict[str, float]] = field(default_factory=list)  # logged train lines
    val_history: List[Dict[str, float]] = field(default_factory=list)
    callback_history: List[Dict[str, float]] = field(default_factory=list)  # callbacks' keys
    callback_errors: List[str] = field(default_factory=list)  # "epoch e: callback: error"
    # per eval epoch, each callback's wall time in s (host clock, ending in a sync)
    callback_seconds: List[Dict[str, float]] = field(default_factory=list)
    callbacks: List = field(default_factory=list)
    step_ms: List[float] = field(default_factory=list)  # per logged line, see fit
    wait_ms: List[float] = field(default_factory=list)
    # the device frame store's resident bytes and upload time; None when the
    # batches are assembled on the host (datamodule.device_store=false)
    store_nbytes: Optional[int] = None
    store_upload_s: Optional[float] = None


class Trainer:
    def __init__(self, cfg: dict, datamodule, run_dir, device=None,
                 callbacks: Optional[List] = None):
        """``run_dir`` may be None for a trainer whose ``fit`` is not called.
        With a started process group the policy trains data-parallel over
        its ranks; ``model`` stays the policy, ``train_model`` its wrapper."""
        self.cfg = cfg
        self.dm = datamodule
        self.run_dir = None if run_dir is None else Path(run_dir)
        self.device = resolve_device(device)
        self.callbacks = list(callbacks or [])
        set_precision_flags()
        self.seed = int(cfg["training"].get("seed", 42))
        self.model = build_policy_for(cfg, seed=self.seed).to(self.device)
        self.is_main = mesh_lib.process_index() == 0
        # JAX's trainer builds its mesh at fsdp 1 only (trainer.py:46)
        mesh = mesh_lib.make_mesh() if torch.distributed.is_initialized() else None
        self.train_model = mesh_lib.wrap_model(self.model, mesh)
        opt_cfg = cfg["model"]["optimizer"]
        self.optimizer = make_optimizer(self.model.parameters(), opt_cfg)
        # the schedule's length as the JAX trainer estimates it (trainer.py:64-68):
        # the config's max_epochs, whatever the run is cut to
        self.estimated_total = (datamodule.steps_per_epoch() * int(cfg["training"]["max_epochs"])
                                if datamodule is not None else 100_000)
        self.scheduler = make_scheduler(self.optimizer, opt_cfg, cfg["model"].get("lr_scheduler"),
                                        self.estimated_total)
        callbacks = cfg.get("callbacks") or {}
        self.kl_schedule = make_kl_schedule(
            callbacks.get("kl_schedule") or {"kind": "constant", "kl_beta": cfg["loss"]["kl_beta"]})
        self.checkpoint_cfg = callbacks.get("checkpoint") or {}
        self.generator = torch.Generator(device=self.device)
        self._preempted = False

    def _transform(self, train: bool):
        dm_cfg = self.cfg["datamodule"]
        bf16 = self.device.type == "cuda" and self.model.compute_dtype == torch.bfloat16
        return make_batch_transform(
            dm_cfg["observation_space"], dm_cfg["proprioception_dims"], dm_cfg["transforms"],
            dtype=torch.bfloat16 if bf16 else torch.float32, train=train,
            stats=self.dm.stats["training" if train else "validation"])

    def _install_signal_handlers(self) -> dict:
        """SIGTERM / SIGUSR1 -> checkpoint at the next step edge; returns the
        handlers they replace. Only the main thread may install them."""
        if threading.current_thread() is not threading.main_thread():
            return {}

        def handler(signum, frame):
            logger.warning("received signal %s: checkpoint at the next step edge", signum)
            self._preempted = True

        return {sig: signal.signal(sig, handler) for sig in (signal.SIGTERM, signal.SIGUSR1)}

    def make_train_step(self):
        """The train step (``train/steps.make_train_step``) of this model and
        optimizer, with the training split's transform."""
        return make_train_step(self.train_model, self.optimizer, self._transform(True),
                               self.cfg["loss"]["clip_auxiliary_loss_beta"],
                               aux_betas_from_loss_cfg(self.cfg["loss"]), device=self.device,
                               scheduler=self.scheduler,
                               gradient_clip_norm=self.cfg["model"]["optimizer"].get(
                                   "gradient_clip_norm"))

    def fit(self, max_epochs: Optional[int] = None, max_steps: Optional[int] = None) -> FitResult:
        cfg, tcfg = self.cfg, self.cfg.get("trainer") or {}
        if self.is_main:
            save_run_config(self.run_dir, cfg)
            # the eval normalises robot_obs with the statistics the run trained on
            save_statistics(self.run_dir, self.dm.stats["training"])
        sink = cfg.get("logger", "jsonl")
        mlog = MetricsLogger(self.run_dir, use_wandb=sink == "wandb", use_tb=sink == "tb",
                             is_main=self.is_main)
        logger.info("git commit: %s", get_git_commit_hash(Path(__file__).parent))
        print_system_env_info(self.device)
        previous = self._install_signal_handlers()
        try:
            return self._fit(cfg, tcfg, mlog, max_epochs, max_steps)
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)
            mlog.close()

    def _fit(self, cfg, tcfg, mlog, max_epochs, max_steps) -> FitResult:
        steps_per_epoch = self.dm.steps_per_epoch()
        ckpt = CheckpointManager(self.run_dir, self.checkpoint_cfg.get("save_top_k", -1),
                                 self.checkpoint_cfg.get("monitor"),
                                 self.checkpoint_cfg.get("mode", "min"),
                                 [k for cb in self.callbacks for k in getattr(cb, "metric_names", ())])
        step, resumed_from = 0, None
        restored = ckpt.restore()
        if restored is not None:
            self.model.load_state_dict(restored["model"])
            self.optimizer.load_state_dict(restored["optimizer"])
            if restored.get("scheduler") is not None:
                self.scheduler.load_state_dict(restored["scheduler"])
            step = resumed_from = restored["step"]
            logger.info("auto-resumed from step %d", step)
        result = FitResult(self.model, step, resumed_from, callbacks=self.callbacks)

        train_step = self.make_train_step()
        val_step = make_val_step(self.model, self._transform(False))
        max_epochs = max_epochs if max_epochs is not None else cfg["training"]["max_epochs"]
        limit_train = tcfg.get("limit_train_batches")
        log_every = tcfg.get("log_every_n_steps", 50)
        total_steps = 0
        loader = self.dm.fused_train_iter()
        if self.dm.device_store is not None:
            result.store_nbytes = self.dm.device_store.nbytes
            result.store_upload_s = self.dm.device_store.upload_s
        # an epoch cut by limit_train_batches is that many steps long (the
        # JAX trainer divides by the uncut length, so a resumed cut run
        # starts over at its first epoch)
        epoch_len = max(min(steps_per_epoch, limit_train or steps_per_epoch), 1)
        for epoch in range(step // epoch_len, max_epochs):
            kl_beta = float(self.kl_schedule(epoch))
            logger.info("epoch %d (kl_beta=%.5f)", epoch, kl_beta)
            loader.epoch = epoch
            it = DevicePrefetcher(loader, self.device)
            launches = dict(kernels.LAUNCHES)
            t_epoch = t_log = time.perf_counter()
            n_samples = since_log = epoch_batches = 0
            wait_log = 0.0
            try:
                for raw in it:
                    self.generator.manual_seed(step_seed(self.seed, TRAIN_STREAM, step))
                    metrics = train_step(raw, self.generator, kl_beta)
                    step += 1
                    total_steps += 1
                    epoch_batches += 1
                    since_log += 1
                    n_samples += sum(b["actions"].shape[0] for b in (
                        raw.values() if "actions" not in raw else [raw]))
                    if total_steps % log_every == 0:
                        names = sorted(metrics)
                        values = torch.stack([metrics[k].float() for k in names]).tolist()
                        now = time.perf_counter()
                        # wall time per step since the last line (each line
                        # waits for its step's metrics) and the share of it
                        # spent waiting for the prefetcher's batches
                        result.step_ms.append(1e3 * (now - t_log) / since_log)
                        result.wait_ms.append(1e3 * (it.wait_s - wait_log) / since_log)
                        line = {**dict(zip(names, values)), "step_ms": result.step_ms[-1],
                                "prefetch_wait_ms": result.wait_ms[-1],
                                "lr": schedule_value(cfg["model"]["optimizer"],
                                                     cfg["model"].get("lr_scheduler"), step,
                                                     self.estimated_total)}
                        result.history.append(mlog.log(line, step, prefix="train/"))
                        t_log, wait_log, since_log = now, it.wait_s, 0
                    if (self._preempted or (max_steps and total_steps >= max_steps)
                            or (limit_train and epoch_batches >= limit_train)):
                        break
            finally:
                it.close()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt_epoch = time.perf_counter() - t_epoch
            # this process's kernel launches in the epoch's train steps
            mlog.log({"samples_per_sec": n_samples / dt_epoch, "epoch_time_s": dt_epoch,
                      "prefetch_wait_s": it.wait_s,
                      **{f"kernel_launches_{k}": n - launches[k]
                         for k, n in kernels.LAUNCHES.items()}}, step, prefix="perf/")

            # validation is skipped after a preemption signal: the
            # timeout-and-resubmit contract wants the checkpoint now
            val_metrics = {} if self._preempted else self.validate(
                val_step, tcfg.get("limit_val_batches"))
            if val_metrics:
                result.val_history.append(mlog.log(val_metrics, step, prefix="val/"))
            saved = {f"val/{k}": v for k, v in val_metrics.items()}
            if not self._preempted:
                self._record_plans(step)
                cb_metrics = self._run_callbacks(epoch, result)
                if cb_metrics:
                    result.callback_history.append(mlog.log(cb_metrics, step))
                saved.update(cb_metrics)
            if self.is_main:
                ckpt.save(step, self.model, self.optimizer, saved, self.scheduler)
            mesh_lib.barrier()
            result.step = step
            if self._preempted or (max_steps and total_steps >= max_steps):
                logger.warning("stopping early (preempted=%s)", self._preempted)
                break
        return result

    def _record_plans(self, step: int) -> None:
        """One validation batch's plans and modality ids for each callback
        that records them (the t-SNE's)."""
        recorders = [cb for cb in self.callbacks if hasattr(cb, "record")]
        if not recorders or not self.model.use_plan:
            return
        if not hasattr(self, "_plan_sampler"):
            self._plan_sampler = make_plan_sampler(self.model, self._transform(False))
        batches = self.dm.val_iter()
        raw = next(batches)
        batches.close()
        self.generator.manual_seed(step_seed(self.seed, PLAN_STREAM, step))
        plans, labels = self._plan_sampler(to_device(raw, self.device), self.generator)
        for cb in recorders:
            cb.record(plans.cpu().numpy(), labels.cpu().numpy())

    def _run_callbacks(self, epoch: int, result: FitResult) -> Dict[str, float]:
        """Each callback on this epoch, the policy in eval mode; returns the
        keys they added. A failing callback is logged and skipped."""
        metrics: Dict[str, float] = {}
        seconds: Dict[str, float] = {}
        self.model.eval()
        try:
            for i, cb in enumerate(self.callbacks):
                t0 = time.perf_counter()
                try:
                    cb(self, epoch=epoch, val_metrics=metrics)
                except Exception as e:  # noqa: BLE001 - never costs the checkpoint
                    logger.exception("callback %r failed; continuing (checkpoint kept)", cb)
                    result.callback_errors.append(f"epoch {epoch}: {type(cb).__name__}: {e!r}")
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                seconds[f"{i}_{type(cb).__name__}"] = time.perf_counter() - t0
        finally:
            self.model.train()
        result.callback_seconds.append(seconds)
        return metrics

    def validate(self, val_step, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Mean val metrics over the validation split's batches (the first
        ``max_batches``); batch i draws from a generator seeded from (seed, i).
        In a data-parallel run each rank validates its shard of the batches
        and the means are averaged over the ranks."""
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        for i, raw in enumerate(self.dm.val_iter()):
            if max_batches and i >= max_batches:
                break
            self.generator.manual_seed(step_seed(self.seed, VAL_STREAM, i))
            m = val_step(to_device(raw, self.device), self.generator)
            for k, v in m.items():
                sums[k] = sums[k] + v.float() if k in sums else v.float()
            count += 1
        if not count:
            return {}
        names = sorted(sums)
        values = torch.stack([sums[k] for k in names])
        if mesh_lib.process_count() > 1:
            values = torch.stack(list(mean_over_ranks(dict(zip(names, values))).values()))
        return {k: v / count for k, v in zip(names, values.tolist())}

