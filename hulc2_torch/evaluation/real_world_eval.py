"""Combined real-world evaluation: type an instruction; the affordance-guided
approach, then the policy's rollout on the Franka Panda.

    python -m hulc2_torch.evaluation.real_world_eval --train-dir RUN \\
        --aff-train-dir AFF_RUN [--aff-lang-embeddings NPY] --dataset-path DATASET \\
        [--camera-calib calib.json] [--ep-len 300] [--no-move] [--show] \\
        [--env-factory module:function] [--device cuda|cpu]

The port's counterpart of ``hulc2_tpu/evaluation/real_world_eval.py:39-157``
(reference: hulc2/rollout/real_world_eval_combined.py:69-171): for each line
of stdin, ``RealWorldAgent.reset(caption)`` predicts the target from the
static frame, deprojects it with the calibrated camera (``--camera-calib``:
JSON ``{width, height, K, T_world_cam}``) and drives the arm near it within
the workspace; then up to ``--ep-len`` policy steps, one fused policy call
each. ``--no-move`` never commands the robot (a dry run); ``--show`` shows
the static camera in a ``cv2`` window (ESC stops the rollout) and raises
``ImportError`` naming cv2 where it is not installed. A policy with the text
tower takes any sentence as token ids; one without looks it up in
``--dataset-path``'s validation ``embeddings.npy`` and refuses a sentence
outside it. A sentence detector's table comes from ``--aff-lang-embeddings``.
The run's statistics normalise robot_obs (``loading.run_statistics``).

The robot is robot_io's (``envs/panda_wrapper.PandaLfpWrapper``), an optional
host dependency; ``--env-factory mod:fn`` builds any object with its surface
instead, e.g. ``hulc2_torch.envs.fake_env:FakeCalvinEnv``. Runs on the card
unless ``--device cpu`` is given, and refuses to run without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence, TextIO

import numpy as np

logger = logging.getLogger(__name__)

# neutral downward orientation + the y>0.4 rotated grip of the reference
# (real_world_eval_combined.py:86-103)
TARGET_ORN = np.array([-3.11, 0.047, 0.027])
ROTATE_ORN = np.array([3.12, -0.022, 1.38])


def load_camera(calib_path):
    """``PinholeCamera`` from a JSON calibration {width, height, K, T_world_cam}."""
    from hulc2_torch.envs.camera import PinholeCamera

    d = json.loads(Path(calib_path).read_text())
    return PinholeCamera(int(d["width"]), int(d["height"]), np.asarray(d["K"], np.float64),
                         np.asarray(d["T_world_cam"], np.float64), d.get("name", "static"))


def build_agent(args):
    """(``RealWorldAgent`` on ``--device`` over the robot or the factory's env,
    the policy's config)."""
    from hulc2_torch.agents.real_world_agent import RealWorldAgent
    from hulc2_torch.evaluation.loading import load_affordance, load_policy, run_statistics
    from hulc2_torch.utils.device import resolve_device, set_precision_flags

    device = resolve_device(args.device)
    set_precision_flags()
    model, cfg, step = load_policy(args.train_dir, args.checkpoint)
    logger.info("policy: step %d of %s", step, args.train_dir)
    affordance = None
    if args.aff_train_dir:
        affordance = load_affordance(args.aff_train_dir, args.aff_checkpoint, device,
                                     seed=cfg["seed"])
    if args.env_factory:
        mod, fn = args.env_factory.rsplit(":", 1)
        env = getattr(importlib.import_module(mod), fn)()
    else:
        from hulc2_torch.envs.panda_wrapper import PandaLfpWrapper

        cams = [load_camera(args.camera_calib)] if args.camera_calib else []
        env = PandaLfpWrapper(cameras=cams, freq_hz=args.freq_hz)
    static_camera = load_camera(args.camera_calib) if args.camera_calib else None
    agent = RealWorldAgent(model.to(device).eval(), cfg["datamodule"], seed=cfg["seed"],
                           stats=run_statistics(args.train_dir, cfg), env=env,
                           affordance=affordance, static_camera=static_camera,
                           target_orn=TARGET_ORN)
    return agent, cfg


def embed_factory(args, cfg):
    """caption -> the policy's goal: token ids for the in-graph tower, else
    the dataset table's embedding (a sentence outside it raises KeyError)."""
    from hulc2_torch.evaluation.evaluate_policy import load_lang_embeddings, policy_has_text_tower

    if policy_has_text_tower(cfg):
        from hulc2_torch.utils.clip_tokenizer import tokenize

        return lambda s: np.asarray(tokenize([s])[0])
    table, _ = load_lang_embeddings(args.dataset_path, cfg["datamodule"]["lang_folder"])

    def embed(s):
        if s not in table:
            raise KeyError(f"{s!r} not in the embeddings table — policies without "
                           "the in-graph text tower only understand annotated sentences")
        return np.asarray(table[s], np.float32)

    return embed


def rollout(agent, caption: str, goal_emb, ep_len: int, move_robot: bool, show: bool) -> int:
    """One instruction: the affordance approach (in ``agent.reset``), then the
    policy loop (reference rollout(), real_world_eval_combined.py:76-83).
    Returns the policy steps taken."""
    agent.reset(caption if agent.affordance is not None else None)
    goal = {"lang": goal_emb}
    obs = agent.env.get_obs()
    for step in range(ep_len):
        action = agent.step(obs, goal)
        if move_robot:
            obs, _, _, _ = agent.env.step(action)
        if show:
            try:
                import cv2
            except ImportError as e:
                raise ImportError("--show needs cv2 (opencv-python), which is not installed") from e
            cv2.imshow("rgb_static", obs["rgb_obs"]["rgb_static"][..., ::-1])
            if cv2.waitKey(1) == 27:  # ESC stops the rollout
                return step + 1
    return ep_len


def main(argv: Optional[Sequence[str]] = None, stdin: Optional[TextIO] = None):
    """Returns the agent."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train-dir", required=True)
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--aff-train-dir", default=None)
    p.add_argument("--aff-checkpoint", type=int, default=None)
    p.add_argument("--aff-lang-embeddings", default=None,
                   help="npy table for the affordance tower (dims must match)")
    p.add_argument("--dataset-path", default=None,
                   help="dataset root whose validation embeddings.npy embeds the instructions")
    p.add_argument("--camera-calib", default=None, help="JSON {width,height,K,T_world_cam}")
    p.add_argument("--ep-len", type=int, default=300)
    p.add_argument("--freq-hz", type=int, default=15)
    p.add_argument("--no-move", action="store_true", help="dry run: never command the robot")
    p.add_argument("--show", action="store_true", help="cv2 preview window")
    p.add_argument("--env-factory", default=None, help="mod:fn returning an env")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    agent, cfg = build_agent(args)
    if agent.affordance is not None and args.aff_lang_embeddings:
        from hulc2_torch.evaluation.evaluate_policy import load_lang_embeddings_file

        table, _ = load_lang_embeddings_file(Path(args.aff_lang_embeddings))
        agent.affordance.lang_table = {k: np.asarray(v, np.float32) for k, v in table.items()}
    embed = embed_factory(args, cfg)

    print("Type an instruction (empty line to quit).")
    for line in stdin if stdin is not None else sys.stdin:
        caption = line.strip()
        if not caption:
            break
        try:
            rollout(agent, caption, embed(caption), args.ep_len, not args.no_move, args.show)
        except KeyError as e:
            print(e)
    return agent


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main(sys.argv[1:])
