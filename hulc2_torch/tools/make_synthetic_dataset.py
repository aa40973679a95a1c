"""Generate a synthetic on-disk dataset in CALVIN's format.

    python -m hulc2_torch.tools.make_synthetic_dataset ROOT [--episodes 2] [--frames 400]
        [--val-episodes 1] [--val-frames 150] [--static-hw 200] [--gripper-hw 84]
        [--n-lang 8] [--seed 0]

The port's copy of ``hulc2_tpu/tools/make_synthetic_dataset.py``: with the
same arguments and seed it writes the same files, array for array. Layout
(reference: hulc2/datasets/npz_dataset.py:26-96): per-frame
``episode_XXXXXXX.npz`` (rgb_static and rgb_gripper uint8 noise, robot_obs
15, scene_obs 24, rel_actions and actions 7), ``ep_start_end_ids.npy``, per
split ``lang_annotations/auto_lang_ann.npy`` and ``embeddings.npy`` (hash
embeddings) and ``statistics.yaml`` with CALVIN's action bounds. The scene
evolves through real task transitions of the fake env, so the oracle, the
annotator and the statistics find genuine windows; the frames are noise, a
fixture for the input pipeline, not for a model's quality. numpy only.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

# CALVIN's real normalization stats + action bounds (protocol constants,
# reference dataset statistics.yaml)
STATS_YAML = """robot_obs:
  - _target_: calvin_agent.utils.transforms.NormalizeVector
    mean: [0.027, -0.21, 0.54, 1.64, -0.02, 1.62, 0.06, -0.44, 0.64, 0.36,
           -1.86, -0.35, 1.58, 0.93, -0.07]
    std: [0.11, 0.13, 0.062, 2.8, 0.04, 0.52, 0.042, 0.27, 0.345, 0.24,
          0.51, 0.42, 0.9, 0.57, 1.0]
act_min_bound: [-0.432188, -0.545456, -0.49, -1.570796, -0.57, -1.570796, -1.0]
act_max_bound: [0.432188, 0.269608, 0.63, 1.570796, 0.52, 1.570796, 1.0]
"""


def make_synthetic_calvin(
    root,
    episodes: int = 2,
    frames_per_episode: int = 400,
    val_episodes: int = 1,
    val_frames: int = 150,
    static_hw: int = 200,
    gripper_hw: int = 84,
    n_lang: int = 8,
    lang_dim: int = 384,
    seed: int = 0,
    lang_folder: str = "lang_annotations",
) -> Path:
    """Write the dataset; returns the root path. Idempotent: skips splits
    whose ep_start_end_ids.npy already exists with matching shape."""
    from hulc2_torch.tools.annotations import ANNOTATION_BANK
    from hulc2_torch.evaluation.tasks import TASK_NAMES

    root = Path(root)
    rng = np.random.default_rng(seed)
    specs = {
        "training": (episodes, frames_per_episode),
        "validation": (val_episodes, val_frames),
    }
    for split, (n_eps, n_frames) in specs.items():
        d = root / split
        ids_file = d / "ep_start_end_ids.npy"
        ranges = [(e * (n_frames + 100), e * (n_frames + 100) + n_frames - 1)
                  for e in range(n_eps)]
        if ids_file.exists() and np.load(ids_file).shape == (n_eps, 2):
            logger.info("%s split already present — skipping", split)
            continue
        d.mkdir(parents=True, exist_ok=True)
        np.save(ids_file, np.asarray(ranges))
        # Oracle-consistent episodes: a symbolic FakeCalvinEnv evolves
        # scene_obs through REAL task transitions (the task model picks only
        # feasible tasks), so the scene-obs oracle, the auto-annotator,
        # dataset statistics, and the vis-modality rollout callback all find
        # genuine windows in this fixture. Frames stay random noise — the
        # fixture exists for pipeline/protocol testing, not model quality.
        from hulc2_torch.envs.fake_env import FakeCalvinEnv
        from hulc2_torch.evaluation.initial_states import get_env_state_for_initial_condition
        from hulc2_torch.evaluation.sequences import enumerate_initial_states
        from hulc2_torch.evaluation.tasks import successor_states
        from hulc2_torch.tools.auto_lang_annotator import hash_embed

        init_states = enumerate_initial_states()
        performed = []  # (frame_idx, task) across the split
        for start, end in ranges:
            # shorter test episodes still get at least one transition
            task_every = max(2, min(40, (end - start) // 2))
            sym = dict(init_states[int(rng.integers(len(init_states)))])
            robot_obs, scene_obs = get_env_state_for_initial_condition(dict(sym))
            rng.integers(1 << 31)  # the JAX env's seed, which it never reads: kept for the stream
            env = FakeCalvinEnv(static_hw=8, gripper_hw=8)
            env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
            for i in range(start, end + 1):
                if i > start and (i - start) % task_every == 0:
                    # feasibility from the PHYSICAL scene (as in
                    # make_expert_dataset): the random filler steps run the
                    # interactive dynamics, so the scene drifts from a
                    # symbolically-evolved state (e.g. a random gripper-open
                    # drops the held block and place_* would crash perform)
                    from hulc2_torch.envs.task_oracle import symbolic_state_from_scene

                    sym = symbolic_state_from_scene(env.scene_obs, held=env._held)
                    feasible = [t for t in TASK_NAMES if len(successor_states(sym, t)) == 1]
                    if feasible:
                        task = feasible[int(rng.integers(len(feasible)))]
                        env.perform(task)
                        performed.append((i, task))
                action = np.clip(rng.standard_normal(7) * 0.2, -1, 1).astype(np.float32)
                env.step(action)
                np.savez(
                    d / f"episode_{i:07d}.npz",
                    rgb_static=rng.integers(0, 256, (static_hw, static_hw, 3), np.uint8),
                    rgb_gripper=rng.integers(0, 256, (gripper_hw, gripper_hw, 3), np.uint8),
                    robot_obs=env.robot_obs.astype(np.float32),
                    scene_obs=env.scene_obs.astype(np.float32),
                    rel_actions=action,
                    actions=np.clip(rng.standard_normal(7), -1, 1).astype(np.float32),
                )
        # language annotations: windows SPANNING actual performed transitions
        # (reference auto_lang_ann semantics); round-robin over transitions
        # up to n_lang windows, deterministic hash embeddings so identical
        # sentences always map to identical vectors
        if not performed:
            logger.warning("%s: no task transitions fit the episode lengths — "
                           "language annotations will be EMPTY", split)
        tasks, anns, indx = [], [], []
        for k in range(n_lang):
            if not performed:
                break
            i, task = performed[k % len(performed)]
            s0, e0 = next((s, e) for s, e in ranges if s <= i <= e)
            lo = max(s0, i - 32)
            hi = min(e0, lo + 63)
            tasks.append(task)
            anns.append(ANNOTATION_BANK[task][int(rng.integers(len(ANNOTATION_BANK[task])))])
            indx.append((int(lo), int(hi)))
        ann = {
            "language": {
                "ann": anns,
                "task": tasks,
                "emb": hash_embed(anns, dim=lang_dim)[:, None, :] if anns
                else np.zeros((0, 1, lang_dim), np.float32),
            },
            "info": {"episodes": [], "indx": indx},
        }
        lf = d / lang_folder
        lf.mkdir(exist_ok=True)
        np.save(lf / "auto_lang_ann.npy", ann, allow_pickle=True)
        # eval-style canonical lookup for EVERY task (reference:
        # embeddings.npy) so rollout callbacks never need stub fallbacks
        emb_lookup = {
            t: {"ann": [ANNOTATION_BANK[t][0]],
                "emb": hash_embed([ANNOTATION_BANK[t][0]], dim=lang_dim)}
            for t in TASK_NAMES
        }
        np.save(lf / "embeddings.npy", emb_lookup)
        (d / "statistics.yaml").write_text(STATS_YAML)
        logger.info("%s: %d episodes x %d frames at %s", split, n_eps, n_frames, d)
    return root


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root")
    p.add_argument("--episodes", type=int, default=2)
    p.add_argument("--frames", type=int, default=400)
    p.add_argument("--val-episodes", type=int, default=1)
    p.add_argument("--val-frames", type=int, default=150)
    p.add_argument("--static-hw", type=int, default=200)
    p.add_argument("--gripper-hw", type=int, default=84)
    p.add_argument("--n-lang", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    make_synthetic_calvin(a.root, a.episodes, a.frames, a.val_episodes, a.val_frames,
                          a.static_hw, a.gripper_hw, a.n_lang, seed=a.seed)


if __name__ == "__main__":
    main(sys.argv[1:])
