"""Training-time evaluation callbacks (``hulc2_tpu/train/callbacks.py``).

- ``RolloutLongHorizonCallback``: the chain benchmark over ``num_sequences``
  5-task chains each eval epoch, the chains split over the data-parallel
  processes and their histograms summed; the first ``num_videos`` chains
  recorded as annotated videos by the main process.
- ``RolloutCallback``: per-task success rates, ``rollouts_per_task`` rollouts
  of each task from initial states where it is unambiguously executable, or,
  with ``rollout_resets_env``, from states the rollout function resets to
  itself (the vision-goal rollouts); the tasks split over the processes.
- ``TSNEPlotCallback``: a t-SNE figure of the plans the trainer records
  from a validation batch.

A callback is called as ``cb(trainer, epoch=..., val_metrics=...)`` after
validation and adds its metrics to ``val_metrics``; a rollout callback's
``metric_names`` are the keys it may add, which a checkpoint monitor may
name before the callback first runs. A rollout callback's
``rollout_fn_factory(trainer)`` gives ``rollout_fn(env, subtask) -> bool``
(None: no goal material for the task); a factory's ``counts``, where it
has them, add up the policy calls of every rollout it served. sklearn and matplotlib
are imported by the t-SNE callback when it draws.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from hulc2_torch.evaluation import harness
from hulc2_torch.evaluation.initial_states import get_env_state_for_initial_condition
from hulc2_torch.evaluation.sequences import enumerate_initial_states, get_sequences
from hulc2_torch.evaluation.tasks import TASK_NAMES, successor_states
from hulc2_torch.parallel.mesh import process_count, process_index
from hulc2_torch.train.rollout_video import RolloutVideo

logger = logging.getLogger(__name__)


def shard_for_process(items: List, process_index: int, process_count: int) -> List:
    """This process's contiguous share of ``items`` (``np.array_split``)."""
    splits = np.array_split(np.arange(len(items)), process_count)
    return [items[i] for i in splits[process_index]]


def allgather_counts(local: np.ndarray) -> np.ndarray:
    """Counters summed over the processes (the identity in one process)."""
    if process_count() == 1:
        return local
    t = torch.as_tensor(np.asarray(local, np.int64))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t)
    return t.cpu().numpy()


class _RecordingEnv:
    """An env whose observations' rgb_static frames go into a RolloutVideo."""

    def __init__(self, env, video: RolloutVideo):
        self._env = env
        self._video = video

    def __getattr__(self, name):
        return getattr(self._env, name)

    def _grab(self, obs):
        try:
            self._video.update(obs["rgb_obs"]["rgb_static"])
        except (KeyError, TypeError):
            pass
        return obs

    def reset(self, *a, **kw):
        return self._grab(self._env.reset(*a, **kw))

    def step(self, action):
        obs, r, d, info = self._env.step(action)
        return self._grab(obs), r, d, info


def _due(epoch: int, start_epoch: int, every_n_epochs: int) -> bool:
    return epoch >= start_epoch and (epoch - start_epoch) % every_n_epochs == 0


class RolloutLongHorizonCallback:
    """The chain benchmark each eval epoch: ``eval_lh/sr_chain_{1..5}`` and
    ``eval_lh/avg_seq_len``."""

    def __init__(self, env_factory: Callable, rollout_fn_factory: Callable,
                 num_sequences: int = 128, every_n_epochs: int = 1, start_epoch: int = 1,
                 video_dir=None, num_videos: int = 1):
        self.env_factory = env_factory
        self.rollout_fn_factory = rollout_fn_factory
        self.num_sequences = num_sequences
        self.every_n_epochs = every_n_epochs
        self.start_epoch = start_epoch
        self.video_dir = video_dir
        self.num_videos = num_videos
        self._sequences = None
        self.videos: List[Path] = []  # the files of the last recording

    @property
    def metric_names(self) -> List[str]:
        return [f"eval_lh/sr_chain_{i}" for i in range(1, 6)] + ["eval_lh/avg_seq_len"]

    def _record_videos(self, rollout_fn, epoch: int) -> None:
        """Videos of the first chains' subtasks: a green or red border and the
        subtask's name, written under ``video_dir``."""
        video = RolloutVideo(self.video_dir, tag_prefix="rollout_lh")
        env = _RecordingEnv(self.env_factory(), video)
        for c, (initial_state, chain) in enumerate(self._sequences[:self.num_videos]):
            robot_obs, scene_obs = get_env_state_for_initial_condition(dict(initial_state))
            env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
            for subtask in chain:
                video.new_video()
                ok = rollout_fn(env, subtask)
                video.draw_outcome(ok)
                video.add_language_instruction(subtask)
                video.finish_video(f"chain{c}_{subtask}")
                if not ok:
                    break
        self.videos = video.write(step=epoch)

    def __call__(self, trainer, epoch: int, val_metrics: Dict, **kw) -> None:
        if not _due(epoch, self.start_epoch, self.every_n_epochs):
            return
        if self._sequences is None:
            self._sequences = get_sequences(self.num_sequences)
        local = shard_for_process(self._sequences, process_index(), process_count())
        env = self.env_factory()
        rollout_fn = self.rollout_fn_factory(trainer)
        if self.video_dir is not None and process_index() == 0:
            try:
                self._record_videos(rollout_fn, epoch)
            except Exception:  # noqa: BLE001 - a diagnostic must not cost the metrics
                logger.exception("rollout video recording failed")
        results = harness.evaluate_policy(rollout_fn, env, sequences=local, progress=False)
        hist = allgather_counts(np.bincount(results, minlength=6).astype(np.int64))
        total = hist.sum()
        for i in range(1, 6):
            val_metrics[f"eval_lh/sr_chain_{i}"] = float(hist[i:].sum() / total)
        val_metrics["eval_lh/avg_seq_len"] = float(np.dot(np.arange(6), hist) / total)
        logger.info("long-horizon eval epoch %d: avg_seq_len=%.3f", epoch,
                    val_metrics["eval_lh/avg_seq_len"])


class RolloutCallback:
    """Per-task success rates: ``<metric_prefix>/<task>_sr`` of each attempted
    task and ``<metric_prefix>/average_sr``."""

    def __init__(self, env_factory: Callable, rollout_fn_factory: Callable,
                 tasks: Optional[List[str]] = None, rollouts_per_task: int = 10,
                 every_n_epochs: int = 5, start_epoch: int = 1, ep_len: int = 120,
                 metric_prefix: str = "tasks", rollout_resets_env: bool = False):
        self.env_factory = env_factory
        self.rollout_fn_factory = rollout_fn_factory
        self.tasks = list(tasks or TASK_NAMES)
        self.rollouts_per_task = rollouts_per_task
        self.every_n_epochs = every_n_epochs
        self.start_epoch = start_epoch
        self.ep_len = ep_len
        self.metric_prefix = metric_prefix
        # the vision-goal rollouts reset the env to a recorded state themselves
        self.rollout_resets_env = rollout_resets_env

    @property
    def metric_names(self) -> List[str]:
        return ([f"{self.metric_prefix}/{t}_sr" for t in self.tasks]
                + [f"{self.metric_prefix}/average_sr"])

    def __call__(self, trainer, epoch: int, val_metrics: Dict, **kw) -> None:
        if not _due(epoch, self.start_epoch, self.every_n_epochs):
            return
        env = self.env_factory()
        rollout_fn = self.rollout_fn_factory(trainer)
        states = enumerate_initial_states()
        my_tasks = shard_for_process(self.tasks, process_index(), process_count())
        succ = np.zeros(len(self.tasks), np.int64)
        attempts = np.zeros(len(self.tasks), np.int64)
        for t_idx, task in enumerate(self.tasks):
            if task not in my_tasks:
                continue
            if self.rollout_resets_env:
                for _ in range(self.rollouts_per_task):
                    r = rollout_fn(env, task)
                    if r is None:  # no goal material for this task
                        break
                    attempts[t_idx] += 1
                    succ[t_idx] += int(bool(r))
                continue
            # initial states where the task is unambiguously executable
            valid = [s for s in states if len(successor_states(s, task)) == 1]
            for k in range(min(self.rollouts_per_task, len(valid))):
                robot_obs, scene_obs = get_env_state_for_initial_condition(valid[k % len(valid)])
                env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
                attempts[t_idx] += 1
                if rollout_fn(env, task):
                    succ[t_idx] += 1
        succ = allgather_counts(succ)
        attempts = allgather_counts(attempts)
        for t_idx, task in enumerate(self.tasks):
            if attempts[t_idx]:
                val_metrics[f"{self.metric_prefix}/{task}_sr"] = float(succ[t_idx] / attempts[t_idx])
        total = attempts.sum()
        val_metrics[f"{self.metric_prefix}/average_sr"] = float(succ.sum() / total) if total else 0.0


class TSNEPlotCallback:
    """``<out_dir>/tsne_epoch<epoch>.png`` from the recorded plans, colored by modality."""

    def __init__(self, out_dir, every_n_epochs: int = 10, max_points: int = 1000):
        self.out_dir = Path(out_dir)
        self.every_n_epochs = every_n_epochs
        self.max_points = max_points
        self.plans: List[np.ndarray] = []
        self.labels: List[int] = []
        self.figures: List[Path] = []

    def record(self, plans: np.ndarray, labels) -> None:
        self.plans.append(np.asarray(plans))
        self.labels.extend(np.asarray(labels).tolist())

    def __call__(self, trainer, epoch: int, val_metrics: Dict, **kw) -> None:
        if epoch % self.every_n_epochs or not self.plans:
            return
        if process_index() != 0:
            self.plans.clear()
            self.labels.clear()
            return
        import matplotlib
        from sklearn.manifold import TSNE

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plans = np.concatenate(self.plans)[:self.max_points]
        labels = np.asarray(self.labels)[:self.max_points]
        emb = TSNE(n_components=2, init="pca",
                   perplexity=min(30, len(plans) - 1)).fit_transform(plans)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        fig, ax = plt.subplots(figsize=(6, 6))
        sc = ax.scatter(emb[:, 0], emb[:, 1], c=labels, cmap="tab20", s=4)
        fig.colorbar(sc)
        path = self.out_dir / f"tsne_epoch{epoch}.png"
        fig.savefig(path, dpi=120)
        plt.close(fig)
        self.figures.append(path)
        self.plans.clear()
        self.labels.clear()
