"""The trainer's callbacks from the config (``hulc2_tpu/train/callback_factory.py``).

``build_callbacks(cfg, run_dir, lang_embeddings)`` reads
``callbacks.rollout_lh``, ``callbacks.rollout`` and ``callbacks.tsne_plot``:

- rollout_lh / rollout: env rollouts of the trainer's live policy. The env
  comes from an ``env`` spec: "fake" (``envs.fake_env``, rendered at the
  policy's camera sizes) or "calvin" (``envs.calvin_wrapper`` over the
  dataset's calvin_env). Each rollout function drives one ``Hulc2Agent``
  per env around the policy, with the training split's statistics, and
  checks the subtask with the env's oracle (calvin_env's native one for
  "calvin") after every step. A language goal is the caption's token ids
  for a policy with a text tower, else its sentence embedding from
  ``lang_embeddings`` (the dataset's ``embeddings.npy``), and a stub
  ``hash_embed`` only where ``HULC2_ALLOW_STUB_EMBEDDINGS`` allows it;
- rollout (with ``vis``, the default): a second per-task callback,
  ``tasks_vis/*``, with visual goals: for each task, validation windows
  where the scene oracle sees it done; the env is reset to the window's
  first frame and the goal is its last;
- tsne_plot: plan-space figures.

Three JAX faults are repaired here: JAX's agent gets no statistics
(``hulc2_tpu/train/callback_factory.py:43``), so a proprio policy sees raw
robot_obs in its rollouts; JAX hands a text-tower policy a float embedding,
which its token embedding refuses (``:85``); JAX's fake env renders at
200/84 px whatever the policy was trained on.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from hulc2_torch.train.callbacks import (RolloutCallback, RolloutLongHorizonCallback,
                                         TSNEPlotCallback)

logger = logging.getLogger(__name__)


def make_env_factory(env_spec: str, dataset_path=None, static_hw: int = 200,
                     gripper_hw: int = 84) -> Callable:
    """A function that makes one env of ``env_spec`` ("fake" or "calvin")."""
    if env_spec == "fake":
        from hulc2_torch.envs.fake_env import FakeCalvinEnv

        return lambda: FakeCalvinEnv(static_hw=static_hw, gripper_hw=gripper_hw)
    if env_spec == "calvin":
        from hulc2_torch.envs.calvin_wrapper import CalvinEnvWrapper, make_calvin_env

        return lambda: CalvinEnvWrapper(make_calvin_env(dataset_path, show_gui=False))
    raise ValueError(f"unknown rollout env {env_spec!r}: fake or calvin")


def _cached_agent(rollout_fn, env, trainer, cfg: dict):
    """One ``Hulc2Agent`` per env instance, cached on the rollout function,
    around the trainer's live policy (the module inside a DDP wrapper) with
    the training split's statistics."""
    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.parallel.mesh import unwrap

    agent = getattr(rollout_fn, "_agent", None)
    if agent is None or agent.env is not env:
        agent = Hulc2Agent(unwrap(trainer.model), cfg["datamodule"], env=env,
                           stats=trainer.dm.stats["training"])
        rollout_fn._agent = agent
    return agent


def _drive_policy(agent, env, goal, subtask: str, oracle, ep_len: int,
                  counts: Optional[Dict[str, int]] = None) -> bool:
    """Restart the agent's carry, then step the policy for up to ``ep_len``
    env steps, asking the oracle after every one whether ``subtask`` is done."""
    agent.reset()
    start = env.get_info()
    obs = env.get_obs()
    for _ in range(ep_len):
        action = agent.step(obs, goal)
        if counts is not None:
            counts["policy_steps"] += 1
        obs, _, _, _ = env.step(action)
        if subtask in oracle.get_task_info_for_set(start, env.get_info(), [subtask]):
            return True
    return False


class _Factory:
    """(trainer) -> rollout_fn(env, subtask), with the ``counts`` of every
    rollout it served: its policy steps and its visual goals (each through
    the val transform once)."""

    def __init__(self, make: Callable):
        self._make = make
        self.counts = {"policy_steps": 0, "goals": 0}

    def __call__(self, trainer):
        return self._make(trainer, self.counts)


def make_policy_rollout_fn_factory(cfg: dict, ep_len: int,
                                   lang_embeddings: Optional[Dict[str, np.ndarray]] = None,
                                   env_spec: str = "calvin") -> _Factory:
    """Language-goal rollouts: the first annotation of each subtask
    (``ANNOTATION_BANK``) as the goal."""
    from hulc2_torch.evaluation.evaluate_policy import policy_has_text_tower

    tower = policy_has_text_tower(cfg)

    def make(trainer, counts):
        from hulc2_torch.envs.task_oracle import make_oracle
        from hulc2_torch.tools.annotations import ANNOTATION_BANK
        from hulc2_torch.tools.auto_lang_annotator import hash_embed, require_stub_embeddings_ok
        from hulc2_torch.utils.clip_tokenizer import tokenize

        oracle = make_oracle(real_env=(env_spec == "calvin"))
        table = lang_embeddings or {}

        def rollout_fn(env, subtask: str) -> bool:
            agent = _cached_agent(rollout_fn, env, trainer, cfg)
            caption = ANNOTATION_BANK[subtask][0]
            if tower:
                goal = {"lang": np.asarray(tokenize([caption])[0])}
            else:
                emb = table.get(caption)
                if emb is None:
                    # success rates from stub embeddings are noise: refused
                    # unless HULC2_ALLOW_STUB_EMBEDDINGS allows them
                    require_stub_embeddings_ok("rollout callback")
                    emb = hash_embed([caption])[0]
                goal = {"lang": np.asarray(emb, np.float32)}
            return _drive_policy(agent, env, goal, subtask, oracle, ep_len, counts)

        return rollout_fn

    return _Factory(make)


def make_vis_rollout_fn_factory(cfg: dict, ep_len: int, dataset_path,
                                env_spec: str = "calvin") -> Optional[_Factory]:
    """Visual-goal rollouts (``hulc2_tpu/train/callback_factory.py:93-153``):
    for each task, the validation windows where the scene oracle sees it
    done; each rollout resets the env to a window's first frame and takes
    its last frame as the goal. None when the validation split has no such
    window."""
    from hulc2_torch.data.episode_index import load_ep_start_end_ids
    from hulc2_torch.data.frame_store import NpzFrameStore
    from hulc2_torch.tools.auto_lang_annotator import detect_task_windows

    val_dir = Path(dataset_path) / "validation"
    rgb_keys = list(cfg["datamodule"]["observation_space"]["rgb_obs"])
    depth_keys = list(cfg["datamodule"]["observation_space"]["depth_obs"])
    keys = rgb_keys + depth_keys + ["robot_obs", "scene_obs"]
    try:
        ep_ids = load_ep_start_end_ids(val_dir, "validation")
        # detection reads scene_obs alone; the full store serves two frames a rollout
        hits = detect_task_windows(NpzFrameStore(val_dir, ["scene_obs"]), ep_ids)
        store = NpzFrameStore(val_dir, keys)
    except (FileNotFoundError, OSError) as e:
        logger.warning("vis rollouts disabled: %s", e)
        return None
    by_task: Dict[str, List] = {}
    for h in hits:
        by_task.setdefault(h["task"], []).append(h["indx"])
    if not by_task:
        logger.warning("vis rollouts disabled: no oracle-detected windows in %s", val_dir)
        return None
    logger.info("vis rollouts: %d tasks with goal windows", len(by_task))

    def env_obs(frame: dict) -> dict:
        return {"rgb_obs": {k: frame[k] for k in rgb_keys if k in frame},
                "depth_obs": {k: frame[k] for k in depth_keys if k in frame},
                "robot_obs": frame["robot_obs"], "scene_obs": frame["scene_obs"]}

    def make(trainer, counts):
        from hulc2_torch.envs.task_oracle import make_oracle

        oracle = make_oracle(real_env=(env_spec == "calvin"))
        served: Dict[str, int] = {}

        def rollout_fn(env, subtask: str):
            windows = by_task.get(subtask)
            if not windows:
                return None  # the task is not in the validation split
            agent = _cached_agent(rollout_fn, env, trainer, cfg)
            k = served.get(subtask, 0)
            served[subtask] = k + 1
            s, e = windows[k % len(windows)]
            first, last = store.load_frame(s), store.load_frame(e)
            env.reset(robot_obs=first["robot_obs"], scene_obs=first["scene_obs"])
            goal = agent.make_visual_goal(env_obs(last))
            counts["goals"] += 1
            return _drive_policy(agent, env, goal, subtask, oracle, ep_len, counts)

        return rollout_fn

    return _Factory(make)


def build_callbacks(cfg: dict, run_dir, lang_embeddings: Optional[Dict[str, np.ndarray]] = None
                    ) -> List:
    """The callbacks that ``cfg["callbacks"]`` asks for."""
    from hulc2_torch.data.device_transforms import camera_sizes

    sizes = camera_sizes(cfg["datamodule"].get("transforms", "rand_shift_96"))
    cbs: List = []
    cb_cfg = cfg.get("callbacks") or {}

    def env_factory(spec: dict) -> Callable:
        return make_env_factory(spec.get("env", "calvin"), spec.get("dataset_path"),
                                sizes["rgb_static"], sizes["rgb_gripper"])

    lh = cb_cfg.get("rollout_lh")
    if lh:
        video_dir = lh.get("video_dir")
        if video_dir == "auto":
            video_dir = str(Path(run_dir) / "videos")
        cbs.append(RolloutLongHorizonCallback(
            env_factory=env_factory(lh),
            rollout_fn_factory=make_policy_rollout_fn_factory(
                cfg, lh.get("ep_len", 360), lang_embeddings, env_spec=lh.get("env", "calvin")),
            num_sequences=lh.get("num_sequences", 128),
            every_n_epochs=lh.get("every_n_epochs", 1),
            start_epoch=lh.get("start_epoch", 1),
            video_dir=video_dir, num_videos=lh.get("num_videos", 1)))
    ro = cb_cfg.get("rollout")
    if ro:
        common = dict(rollouts_per_task=ro.get("rollouts_per_task", 10),
                      every_n_epochs=ro.get("every_n_epochs", 5),
                      start_epoch=ro.get("start_epoch", 1), ep_len=ro.get("ep_len", 120))
        cbs.append(RolloutCallback(
            env_factory=env_factory(ro),
            rollout_fn_factory=make_policy_rollout_fn_factory(
                cfg, ro.get("ep_len", 120), lang_embeddings, env_spec=ro.get("env", "calvin")),
            **common))
        # both modalities, as the reference's rollout callback
        vis_ds = ro.get("dataset_path") or cfg.get("datamodule", {}).get("root_data_dir")
        if ro.get("vis", True) and vis_ds:
            vis_factory = make_vis_rollout_fn_factory(cfg, ro.get("ep_len", 120), vis_ds,
                                                      env_spec=ro.get("env", "calvin"))
            if vis_factory is not None:
                cbs.append(RolloutCallback(env_factory=env_factory(ro),
                                           rollout_fn_factory=vis_factory,
                                           metric_prefix="tasks_vis", rollout_resets_env=True,
                                           **common))
    if cb_cfg.get("tsne_plot"):
        cbs.append(TSNEPlotCallback(run_dir,
                                    every_n_epochs=cb_cfg["tsne_plot"].get("every_n_epochs", 10)))
    return cbs
