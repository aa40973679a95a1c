"""Interactive policy rollouts: type an instruction, watch the policy act.

    python -m hulc2_torch.evaluation.interactive --train-dir RUN --fake-env \\
        [--ep-len 360] [--show] [--device cuda|cpu]
    python -m hulc2_torch.evaluation.interactive --train-dir RUN --dataset-path DATASET ...

The port's counterpart of ``hulc2_tpu/evaluation/interactive.py`` (reference:
hulc2/evaluation/test_policy_interactive.py:131, rollouts_interactive.py:40).
It loads the newest checkpoint of a training run of the port, and for each
line of stdin runs one ``Hulc2Agent`` for up to ``--ep-len`` steps, stopping
when the oracle sees any task completed; it prints that task (the first by
name, when several complete at once) or that none was, with the steps taken.
The env keeps its state from one instruction to the next; an empty line ends
the loop. ``--show`` shows the static camera in a ``cv2`` window.

``--fake-env`` runs a ``FakeCalvinEnv`` at the run's transform preset's sizes
(``data/device_transforms.camera_sizes``), as ``evaluate_policy`` does (the
JAX package renders at 200 and 84 pixels and lets the transform resize),
scored by the scene-obs oracle; its policy needs the in-graph text tower,
which takes any sentence as CLIP-BPE token ids. Without it the CALVIN
simulator is built from ``--dataset-path`` (``envs/calvin_wrapper``) and
scored by ``envs/task_oracle.make_oracle``'s choice; a policy without the
text tower looks each sentence up in that dataset's validation
``embeddings.npy``, and a sentence outside the table gets a stub
``hash_embed`` (allowed only with ``HULC2_ALLOW_STUB_EMBEDDINGS=1``) with a
warning that the policy will not understand it. Runs on the card unless
``--device cpu`` is given, and refuses to run without one.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import List, Optional, Sequence, TextIO, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def table_embedder(dataset_path, lang_folder: str):
    """sentence -> its embedding in the dataset's validation table; a sentence
    outside it gets a stub ``hash_embed`` at the table's width, with a warning
    (``hulc2_tpu/evaluation/interactive.py:63-70``)."""
    from hulc2_torch.evaluation.evaluate_policy import load_lang_embeddings
    from hulc2_torch.tools.auto_lang_annotator import hash_embed, require_stub_embeddings_ok

    table, _ = load_lang_embeddings(dataset_path, lang_folder)
    dim = np.asarray(next(iter(table.values()))).shape[-1]

    def embed(s: str) -> np.ndarray:
        if s in table:
            return np.asarray(table[s], np.float32)
        require_stub_embeddings_ok(f"the instruction {s!r}, which is not in the embeddings table")
        print(f"WARNING: {s!r} is not in the embeddings table — using a stub hash embedding; "
              "the policy will NOT understand it")
        return hash_embed([s], dim)[0]

    return embed


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
                   help="the interactive FakeCalvinEnv backend (default: the CALVIN simulator)")
    p.add_argument("--dataset-path", default=None,
                   help="without --fake-env: the dataset whose render config builds the CALVIN "
                        "env and whose embeddings.npy embeds the instructions")
    p.add_argument("--show", action="store_true", help="a cv2 window with the static camera")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.fake_env and args.dataset_path is None:
        p.error("--dataset-path is required without --fake-env: the CALVIN env is built from "
                "its recorded render config")
    check_run_dir(p, Path(args.train_dir), None)

    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.core.checkpoint import load_run_config
    from hulc2_torch.data.device_transforms import camera_sizes
    from hulc2_torch.envs.task_oracle import make_oracle
    from hulc2_torch.evaluation.loading import load_policy, run_statistics
    from hulc2_torch.evaluation.tasks import TASK_NAMES
    from hulc2_torch.utils.clip_tokenizer import tokenize
    from hulc2_torch.utils.device import resolve_device, set_precision_flags

    tower = policy_has_text_tower(load_run_config(Path(args.train_dir)))
    if args.fake_env and not tower:
        p.error("interactive instructions on the fake env need a policy with the in-graph text "
                "tower (model.language_encoder clip_text): a policy over sentence embeddings "
                "takes its table from --dataset-path, on the CALVIN env")
    device = resolve_device(args.device)
    set_precision_flags()
    model, cfg, step = load_policy(args.train_dir)
    logger.info("policy: step %d of %s", step, args.train_dir)
    if args.fake_env:
        from hulc2_torch.envs.fake_env import FakeCalvinEnv

        sizes = camera_sizes(cfg["datamodule"]["transforms"])
        env = FakeCalvinEnv(static_hw=sizes["rgb_static"], gripper_hw=sizes["rgb_gripper"])
    else:
        from hulc2_torch.envs.calvin_wrapper import make_wrapped_calvin_env

        env = make_wrapped_calvin_env(args.dataset_path)
    if tower:
        def embed(s):
            return tokenize([s])[0]
    else:
        embed = table_embedder(args.dataset_path, cfg["datamodule"]["lang_folder"])
    agent = Hulc2Agent(model.to(device).eval(), cfg["datamodule"], seed=cfg["seed"],
                       stats=run_statistics(args.train_dir, cfg))
    oracle = make_oracle(real_env=not args.fake_env)
    env.reset()
    verdicts = []
    print("Type an instruction (or a task name like 'open_drawer'); empty line to quit.")
    for line in stdin if stdin is not None else sys.stdin:
        caption = line.strip()
        if not caption:
            break
        agent.reset_env_slot(0)
        start = env.get_info()
        goal = {"lang": embed(caption)}
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
