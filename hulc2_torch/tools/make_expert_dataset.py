"""Generate an expert play dataset from the interactive fake env.

    python -m hulc2_torch.tools.make_expert_dataset ROOT --episodes 24 \\
        --tasks-per-episode 24 [--val-episodes 4] [--val-tasks-per-episode 12] \\
        [--static-hw 96] [--gripper-hw 64] [--lang-tokens] \\
        [--holdout-paraphrases 4] [--seed 0] [--unaligned-lang-windows]

The port's numpy copy of ``hulc2_tpu/tools/make_expert_dataset.py``: with
the same arguments and seed it writes the same files. The scripted expert
(``envs/scripted_expert.py``) performs long feasible task sequences in the
interactive ``FakeCalvinEnv``; every frame (rendered static and gripper RGB,
exact static depth) is recorded with the CALVIN rel-action taken at it.

Layout is the reference CALVIN one: per split (``training``, ``validation``)
per-frame ``episode_XXXXXXX.npz`` (rgb_static, rgb_gripper, depth_static,
robot_obs 15, scene_obs 24, rel_actions 7, actions 7), ``ep_start_end_ids.npy``,
``statistics.yaml`` and ``lang_annotations/auto_lang_ann.npy`` +
``embeddings.npy``. ``--lang-tokens`` (the flagship's) stores each sentence's
CLIP-BPE token ids; otherwise a deterministic hash embedding of one
canonical phrasing per task. A split whose ``ep_start_end_ids.npy`` exists is
skipped.

The expert steps the env without rendering; each frame is rendered from its
recorded state afterwards. Rendering is most of the cost, so once an
episode shows that many frames are left, worker processes (one for every CPU
but the expert's) render and save them while the expert goes on: the same
files, sooner. With one CPU, or a few chunks of frames, it all stays in this
process.
"""
from __future__ import annotations

import argparse
import collections
import logging
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

# CALVIN's normalization stats + action bounds (protocol constants of the
# reference dataset's statistics.yaml), as ``tools/make_synthetic_dataset.py``
# of the JAX package writes them
STATS_YAML = """robot_obs:
  - _target_: calvin_agent.utils.transforms.NormalizeVector
    mean: [0.027, -0.21, 0.54, 1.64, -0.02, 1.62, 0.06, -0.44, 0.64, 0.36,
           -1.86, -0.35, 1.58, 0.93, -0.07]
    std: [0.11, 0.13, 0.062, 2.8, 0.04, 0.52, 0.042, 0.27, 0.345, 0.24,
          0.51, 0.42, 0.9, 0.57, 1.0]
act_min_bound: [-0.432188, -0.545456, -0.49, -1.570796, -0.57, -1.570796, -1.0]
act_max_bound: [0.432188, 0.269608, 0.63, 1.570796, 0.52, 1.570796, 1.0]
"""


def _write_frames(out_dir: Path, static_hw: int, gripper_hw: int, records) -> None:
    """Render and save frames: ``records`` are (index, robot_obs, scene_obs,
    held block, rel action, abs action) tuples. A frame is the fake env's
    ``get_obs`` of an env set to the recorded state (frames are a pure
    function of the state and the held block)."""
    from hulc2_torch.envs.fake_env import FakeCalvinEnv

    env = FakeCalvinEnv(static_hw, gripper_hw)
    for idx, robot_obs, scene_obs, held, action, abs_action in records:
        env.robot_obs, env.scene_obs, env._held = robot_obs, scene_obs, held
        o = env.get_obs()
        np.savez(
            out_dir / f"episode_{idx:07d}.npz",
            rgb_static=o["rgb_obs"]["rgb_static"],
            rgb_gripper=o["rgb_obs"]["rgb_gripper"],
            depth_static=o["depth_obs"]["depth_static"].astype(np.float16),
            robot_obs=np.asarray(robot_obs, np.float32),
            scene_obs=np.asarray(scene_obs, np.float32),
            rel_actions=np.asarray(action, np.float32),
            actions=abs_action,
        )


class _RenderPool:
    """Spawned worker processes that render and save chunks of frames while
    the expert runs on. ``submit`` keeps at most four chunks a worker queued
    and raises a worker's error; ``drain`` waits for every chunk. A worker
    that dies breaks the pool, and the next wait raises."""

    def __init__(self, workers: int):
        self.pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
        self.depth = 4 * workers
        self.pending = collections.deque()

    def submit(self, *args) -> None:
        self.pending.append(self.pool.submit(_write_frames, *args))
        while self.pending and (self.pending[0].done() or len(self.pending) > self.depth):
            self.pending.popleft().result()

    def drain(self) -> None:
        while self.pending:
            self.pending.popleft().result()

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)


class _FrameWriter:
    """Records (pre-step state, action) pairs: frame i carries the action
    taken *at* frame i, the CALVIN convention the window datasets pair
    observations and actions with. The env steps without rendering; each
    frame is rendered from its recorded state here, or by ``pool`` in chunks
    of ``CHUNK`` frames."""

    CHUNK = 256
    # starting the workers costs about as long as rendering a chunk or two in
    # this process: the pool starts once an episode shows at least this many
    # chunks left in its split (the split's other episodes at its length)
    POOL_MIN_CHUNKS = 8

    def __init__(self, out_dir: Path, start_idx: int, env, pool: Optional[_RenderPool] = None):
        self.out = out_dir
        self.idx = start_idx
        self.env = env
        self.pool = pool
        self.records = []
        self.prev = None
        self.n = 0

    def start(self, obs) -> None:
        self.prev = (obs["robot_obs"], obs["scene_obs"], self.env._held)

    def __call__(self, obs, action, info) -> None:
        abs_action = np.concatenate([
            np.asarray(obs["robot_obs"][:6], np.float32),
            [np.float32(np.sign(action[6]) or 1.0)],
        ])
        self.records.append((self.idx, *self.prev, np.asarray(action, np.float32), abs_action))
        self.prev = (obs["robot_obs"], obs["scene_obs"], self.env._held)
        self.idx += 1
        self.n += 1
        if len(self.records) >= self.CHUNK:
            self.flush()

    def flush(self, wait: bool = False) -> None:
        """Write the recorded frames, in this process when there is no pool
        or ``wait`` asks for them on disk before the next is written."""
        args = (self.out, self.env.static_hw, self.env.gripper_hw, self.records)
        self.records = []
        if self.pool is None or wait:
            _write_frames(*args)
        elif args[-1]:
            self.pool.submit(*args)


def make_expert_dataset(
    root,
    episodes: int = 24,
    tasks_per_episode: int = 24,
    val_episodes: int = 4,
    val_tasks_per_episode: int = 12,
    static_hw: int = 96,
    gripper_hw: int = 64,
    noise: float = 0.03,
    idle_steps: int = 4,
    seed: int = 0,
    lang_window: int = 64,
    lang_stride: int = 8,
    canonical_lang: bool = True,
    lang_tokens: bool = False,
    holdout_paraphrases: int = 0,
    balance_tasks: bool = True,
    align_lang_windows: bool = True,
) -> Path:
    """Write the dataset; returns the root path. Idempotent per split.
    ``align_lang_windows=False`` annotates every window in which exactly one
    task completes, unaligned (``annotate_dataset(align_end=False)``)."""
    from hulc2_torch.envs.fake_env import FakeCalvinEnv
    from hulc2_torch.envs.scripted_expert import ScriptedExpert
    from hulc2_torch.envs.task_oracle import symbolic_state_from_scene
    from hulc2_torch.evaluation.initial_states import get_env_state_for_initial_condition
    from hulc2_torch.evaluation.sequences import enumerate_initial_states
    from hulc2_torch.evaluation.tasks import TASK_NAMES, successor_states
    from hulc2_torch.tools.auto_lang_annotator import annotate_dataset, hash_embed

    root = Path(root)
    specs = {
        "training": (episodes, tasks_per_episode, seed),
        "validation": (val_episodes, val_tasks_per_episode, seed + 7919),
    }
    init_states = enumerate_initial_states()
    workers = (os.cpu_count() or 1) - 1  # a CPU is the expert's
    pool = None
    try:
        for split, (n_eps, n_tasks, split_seed) in specs.items():
            if n_eps <= 0:  # e.g. --val-episodes 0: nothing to write or annotate
                continue
            d = root / split
            ids_file = d / "ep_start_end_ids.npy"
            if ids_file.exists():
                logger.info("%s split already present — skipping", split)
                continue
            d.mkdir(parents=True, exist_ok=True)
            rng = np.random.default_rng(split_seed)
            ranges = []
            next_start = 0
            t0 = time.time()
            task_counts: dict = {}
            fail_counts: dict = {}
            for ep in range(n_eps):
                sym = dict(init_states[int(rng.integers(len(init_states)))])
                robot_obs, scene_obs = get_env_state_for_initial_condition(dict(sym))
                # the JAX generator seeds its env's (unused) generator with this
                # draw; it is drawn here too so that both consume one stream
                rng.integers(1 << 31)
                env = FakeCalvinEnv(static_hw=static_hw, gripper_hw=gripper_hw, render_obs=False)
                obs = env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
                expert = ScriptedExpert(env, rng=rng, noise=noise)
                writer = _FrameWriter(d, next_start, env, pool)
                writer.start(obs)
                consec_fails = 0
                for _ in range(n_tasks):
                    # feasibility from the PHYSICAL scene, re-derived every draw:
                    # chained symbolic successors drift from the noisy execution
                    sym = symbolic_state_from_scene(env.scene_obs, held=env._held)
                    feasible = [t for t in TASK_NAMES if len(successor_states(sym, t)) == 1]
                    if not feasible:
                        break
                    if balance_tasks:
                        # inverse-count weighting keeps the executed-task
                        # histogram flat: tasks whose preconditions are rarely
                        # feasible would be starved by a uniform draw
                        w = np.asarray([1.0 / (1.0 + task_counts.get(t, 0)) for t in feasible])
                        task = feasible[int(rng.choice(len(feasible), p=w / w.sum()))]
                    else:
                        task = feasible[int(rng.integers(len(feasible)))]
                    if not expert.solve(task, recorder=writer):
                        fail_counts[task] = fail_counts.get(task, 0) + 1
                        consec_fails += 1
                        if consec_fails >= 3:
                            logger.warning("expert: 3 consecutive failures — ending episode")
                            break
                        continue
                    consec_fails = 0
                    task_counts[task] = task_counts.get(task, 0) + 1
                    # short idle/noise segment between tasks (play-like pauses)
                    for _ in range(int(rng.integers(1, idle_steps + 1))):
                        a = np.clip(rng.normal(0, 0.15, 7), -1, 1)
                        a[6] = env.robot_obs[14]
                        o, _, _, info = env.step(a)
                        writer(o, a, info)
                if writer.n < 2:
                    # its frame stays on disk until the next episode's first
                    # frame overwrites it, as in the JAX package: written now
                    writer.flush(wait=True)
                    continue
                writer.flush()
                ranges.append((next_start, writer.idx - 1))
                next_start = writer.idx + 100
                logger.info("%s: episode %d/%d (%d frames, %.0f s)", split, ep + 1, n_eps,
                            writer.idx - ranges[-1][0], time.time() - t0)
                left = (n_eps - ep - 1) * writer.n
                if pool is None and workers > 0 and left >= writer.POOL_MIN_CHUNKS * writer.CHUNK:
                    pool = _RenderPool(workers)
            if pool is not None:
                pool.drain()
            np.save(ids_file, np.asarray(ranges))
            (d / "statistics.yaml").write_text(STATS_YAML)
            logger.info("%s: %d episodes, %d frames, tasks: %s", split, len(ranges),
                        sum(e - s + 1 for s, e in ranges),
                        dict(sorted(task_counts.items(), key=lambda kv: -kv[1])))
            if fail_counts:
                logger.info("%s: expert failures: %s", split,
                            dict(sorted(fail_counts.items(), key=lambda kv: -kv[1])))
            # language annotations from oracle-detected windows: sentences and
            # CLIP-BPE token ids for the in-graph text tower (paraphrases sampled
            # from the bank minus the held-out ones), or the hash embedding of
            # one canonical phrasing per task
            annotate_dataset(d, "tokens" if lang_tokens else hash_embed, window=lang_window,
                             stride=lang_stride, seed=split_seed,
                             canonical=canonical_lang and not lang_tokens,
                             holdout_k=holdout_paraphrases, align_end=align_lang_windows)
    finally:
        if pool is not None:
            pool.close()
    return root


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root")
    p.add_argument("--episodes", type=int, default=24)
    p.add_argument("--tasks-per-episode", type=int, default=24)
    p.add_argument("--val-episodes", type=int, default=4)
    p.add_argument("--val-tasks-per-episode", type=int, default=12)
    p.add_argument("--static-hw", type=int, default=96)
    p.add_argument("--gripper-hw", type=int, default=64)
    p.add_argument("--noise", type=float, default=0.03)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lang-window", type=int, default=64)
    p.add_argument("--lang-stride", type=int, default=8)
    p.add_argument("--paraphrase-lang", action="store_true",
                   help="sample paraphrases from the full annotation bank instead of one "
                        "canonical phrasing per task")
    p.add_argument("--lang-tokens", action="store_true",
                   help="annotate with sentences + CLIP-BPE token ids (for models with "
                        "in-graph text towers; implies paraphrase sampling)")
    p.add_argument("--holdout-paraphrases", type=int, default=0,
                   help="exclude the last K paraphrases per task from annotation sampling")
    p.add_argument("--no-balance-tasks", action="store_true",
                   help="uniform feasible-task draws instead of inverse-count balancing")
    p.add_argument("--unaligned-lang-windows", action="store_true",
                   help="annotate every --lang-window window in which exactly one task "
                        "completes, not re-anchored to end at the completion: the JAX "
                        "package's annotation before it aligned its windows, which the "
                        "round-5 flagship run's dataset has (docs/runs/r5_flagship)")
    a = p.parse_args(argv)
    return make_expert_dataset(a.root, a.episodes, a.tasks_per_episode, a.val_episodes,
                               a.val_tasks_per_episode, a.static_hw, a.gripper_hw, a.noise,
                               seed=a.seed, lang_window=a.lang_window, lang_stride=a.lang_stride,
                               canonical_lang=not a.paraphrase_lang, lang_tokens=a.lang_tokens,
                               holdout_paraphrases=a.holdout_paraphrases,
                               balance_tasks=not a.no_balance_tasks,
                               align_lang_windows=not a.unaligned_lang_windows)


if __name__ == "__main__":
    main(sys.argv[1:])
