"""The trainer loop: epochs, validation, checkpoints, auto-resume
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
- per-epoch validation (``trainer.limit_val_batches``) and a checkpoint
  every epoch, every step kept (``save_top_k: -1``);
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
uninterrupted one. The trainer's callbacks (rollouts, t-SNE) and the
wandb / tensorboard sinks are not ported.
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

from hulc2_torch.core.checkpoint import CheckpointManager, save_run_config
from hulc2_torch.core.metrics import MetricsLogger
from hulc2_torch.data.device_transforms import make_batch_transform
from hulc2_torch.data.loader import DevicePrefetcher, to_device
from hulc2_torch.data.statistics import save_statistics
from hulc2_torch.models.build import build_policy_for
from hulc2_torch.models.hulc2 import Hulc2
from hulc2_torch.train.kl_schedule import make_kl_schedule
from hulc2_torch.train.optim import make_optimizer, make_scheduler, schedule_value
from hulc2_torch.train.steps import aux_betas_from_loss_cfg, make_train_step, make_val_step
from hulc2_torch.utils.device import resolve_device, set_precision_flags

logger = logging.getLogger(__name__)

TRAIN_STREAM, VAL_STREAM = 0, 1


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
    step_ms: List[float] = field(default_factory=list)  # per logged line, see fit
    wait_ms: List[float] = field(default_factory=list)
    # the device frame store's resident bytes and upload time; None when the
    # batches are assembled on the host (datamodule.device_store=false)
    store_nbytes: Optional[int] = None
    store_upload_s: Optional[float] = None


class Trainer:
    def __init__(self, cfg: dict, datamodule, run_dir, device=None):
        """``run_dir`` may be None for a trainer whose ``fit`` is not called."""
        self.cfg = cfg
        self.dm = datamodule
        self.run_dir = None if run_dir is None else Path(run_dir)
        self.device = resolve_device(device)
        set_precision_flags()
        self.seed = int(cfg["training"].get("seed", 42))
        self.model = build_policy_for(cfg, seed=self.seed).to(self.device)
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
        self.save_top_k = (callbacks.get("checkpoint") or {}).get("save_top_k", -1)
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
        return make_train_step(self.model, self.optimizer, self._transform(True),
                               self.cfg["loss"]["clip_auxiliary_loss_beta"],
                               aux_betas_from_loss_cfg(self.cfg["loss"]), device=self.device,
                               scheduler=self.scheduler,
                               gradient_clip_norm=self.cfg["model"]["optimizer"].get(
                                   "gradient_clip_norm"))

    def fit(self, max_epochs: Optional[int] = None, max_steps: Optional[int] = None) -> FitResult:
        cfg, tcfg = self.cfg, self.cfg.get("trainer") or {}
        save_run_config(self.run_dir, cfg)
        # the eval normalises robot_obs with the statistics the run trained on
        save_statistics(self.run_dir, self.dm.stats["training"])
        mlog = MetricsLogger(self.run_dir)
        previous = self._install_signal_handlers()
        try:
            return self._fit(cfg, tcfg, mlog, max_epochs, max_steps)
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)
            mlog.close()

    def _fit(self, cfg, tcfg, mlog, max_epochs, max_steps) -> FitResult:
        steps_per_epoch = self.dm.steps_per_epoch()
        ckpt = CheckpointManager(self.run_dir, self.save_top_k)
        step, resumed_from = 0, None
        restored = ckpt.restore()
        if restored is not None:
            self.model.load_state_dict(restored["model"])
            self.optimizer.load_state_dict(restored["optimizer"])
            if restored.get("scheduler") is not None:
                self.scheduler.load_state_dict(restored["scheduler"])
            step = resumed_from = restored["step"]
            logger.info("auto-resumed from step %d", step)
        result = FitResult(self.model, step, resumed_from)

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
            mlog.log({"samples_per_sec": n_samples / dt_epoch, "epoch_time_s": dt_epoch,
                      "prefetch_wait_s": it.wait_s}, step, prefix="perf/")

            # validation is skipped after a preemption signal: the
            # timeout-and-resubmit contract wants the checkpoint now
            val_metrics = {} if self._preempted else self.validate(
                val_step, tcfg.get("limit_val_batches"))
            if val_metrics:
                result.val_history.append(mlog.log(val_metrics, step, prefix="val/"))
            ckpt.save(step, self.model, self.optimizer, val_metrics, self.scheduler)
            result.step = step
            if self._preempted or (max_steps and total_steps >= max_steps):
                logger.warning("stopping early (preempted=%s)", self._preempted)
                break
        return result

    def validate(self, val_step, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Mean val metrics over the validation split's batches (the first
        ``max_batches``); batch i draws from a generator seeded from (seed, i)."""
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
        values = torch.stack([sums[k] for k in names]).tolist()
        return {k: v / count for k, v in zip(names, values)}

