"""Interactive policy rollouts: type an instruction, watch the policy act.

    python -m hulc2_torch.evaluation.interactive --train-dir RUN --fake-env \\
        [--ep-len 360] [--show] [--device cuda|cpu]

The port's counterpart of ``hulc2_tpu/evaluation/interactive.py`` (reference:
hulc2/evaluation/test_policy_interactive.py:131, rollouts_interactive.py:40).
It loads the newest checkpoint of a training run of the port, and for each
line of stdin runs one ``Hulc2Agent`` on a ``FakeCalvinEnv`` for up to
``--ep-len`` steps, the line's CLIP-BPE token ids as the goal, stopping when
the scene-obs oracle sees any task completed; it prints that task (the
first by name, when several complete at once) or that none was, with the
steps taken. The env keeps its state from one instruction to the next; an
empty line ends the loop. ``--show`` shows the static camera in a ``cv2``
window.

The env renders at the run's transform preset's sizes
(``data/device_transforms.camera_sizes``), as ``evaluate_policy`` does; the
JAX package renders at 200 and 84 pixels and lets the transform resize.
Only the fake env and policies with the in-graph text tower (which take any
sentence) are ported. Runs on the card unless ``--device cpu`` is given, and
refuses to run without one.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import List, Optional, Sequence, TextIO, Tuple

logger = logging.getLogger(__name__)


def main(argv: Optional[Sequence[str]] = None,
         stdin: Optional[TextIO] = None) -> List[Tuple[str, Optional[str], int]]:
    """Returns (instruction, completed task or None, steps) per instruction."""
    from hulc2_torch.evaluation.evaluate_policy import check_run_dir, policy_has_text_tower

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train-dir", required=True,
                   help="a training run dir of the port; its newest checkpoint is loaded")
    p.add_argument("--ep-len", type=int, default=360, help="step budget per instruction")
    p.add_argument("--fake-env", action="store_true",
                   help="the interactive FakeCalvinEnv backend (the only one ported)")
    p.add_argument("--show", action="store_true", help="a cv2 window with the static camera")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.fake_env:
        p.error("--fake-env is required: the real CALVIN env is not ported")
    check_run_dir(p, Path(args.train_dir), None)

    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.core.checkpoint import load_run_config
    from hulc2_torch.data.device_transforms import camera_sizes
    from hulc2_torch.envs.fake_env import FakeCalvinEnv
    from hulc2_torch.envs.task_oracle import SceneObsTaskOracle
    from hulc2_torch.evaluation.loading import load_policy
    from hulc2_torch.evaluation.tasks import TASK_NAMES
    from hulc2_torch.utils.clip_tokenizer import tokenize
    from hulc2_torch.utils.device import resolve_device, set_precision_flags

    if not policy_has_text_tower(load_run_config(Path(args.train_dir))):
        p.error("interactive instructions need a policy with the in-graph text tower "
                "(model.language_encoder clip_text): the port has no embedding tables")
    device = resolve_device(args.device)
    set_precision_flags()
    model, cfg, step = load_policy(args.train_dir)
    logger.info("policy: step %d of %s", step, args.train_dir)
    sizes = camera_sizes(cfg["datamodule"]["transforms"])
    env = FakeCalvinEnv(static_hw=sizes["rgb_static"], gripper_hw=sizes["rgb_gripper"])
    agent = Hulc2Agent(model.to(device).eval(), cfg["datamodule"], seed=cfg["seed"])
    oracle = SceneObsTaskOracle()
    env.reset()
    verdicts = []
    print("Type an instruction (or a task name like 'open_drawer'); empty line to quit.")
    for line in stdin if stdin is not None else sys.stdin:
        caption = line.strip()
        if not caption:
            break
        agent.reset_env_slot(0)
        start = env.get_info()
        goal = {"lang": tokenize([caption])[0]}
        obs = env.get_obs()
        done_task, t = None, -1
        for t in range(args.ep_len):
            obs, _, _, _ = env.step(agent.step(obs, goal))
            if args.show:
                import cv2

                cv2.imshow("rgb_static", obs["rgb_obs"]["rgb_static"][:, :, ::-1])
                cv2.waitKey(1)
            detected = oracle.get_task_info_for_set(start, env.get_info(), TASK_NAMES)
            if detected:
                done_task = sorted(detected)[0]
                break
        verdicts.append((caption, done_task, t + 1))
        print(f"-> {'completed ' + done_task if done_task else 'no task completed'} "
              f"({t + 1} steps)")
        print("next instruction:")
    return verdicts


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(sys.argv[1:])
