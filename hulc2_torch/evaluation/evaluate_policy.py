"""CALVIN chain evaluation of a policy on the interactive fake env.

    python -m hulc2_torch.evaluation.evaluate_policy --synthetic --fake-env \\
        [--device-render] [--n-envs 32] [--cohorts 4] [--num-sequences 1000] \\
        [--ep-len 360] [--log-dir DIR] [--device cuda|cpu] [key=value ...]

The port's counterpart of the fake-env branch of
``hulc2_tpu/evaluation/evaluate_policy.py:124``. ``--synthetic`` evaluates the
flagship policy (``configs/flagship.py`` with dotted ``key=value`` overrides)
with random weights from ``build_policy(cfg, seed)``, the convention of
``python -m hulc2_torch.training --synthetic``. The goal of each subtask is the
BPE token ids of the task's canonical sentence, which the policy's text tower
encodes on every step. ``--n-envs`` fake envs run in lockstep in ``--cohorts``
cohorts whose policy steps overlap (``batched_eval.PipelinedEvaluator``);
with ``--device-render`` the envs keep only their state and the policy step
renders their frames on the device. Success is scored by the scene-obs
oracle. The agents' draws come from generators seeded from the config's
``seed``. Writes ``results.json``, ``eval_diagnostics.json`` and snapshots in
``partial_results.json`` to ``--log-dir``.

Runs on the card unless ``--device cpu`` is given, and refuses to run without
one. Not ported yet: ``--train-dir`` (the port's checkpoints), the real CALVIN
env, the hierarchical mode, the process env farm and the paraphrase and
single-step protocols.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from hulc2_torch.evaluation import harness
from hulc2_torch.evaluation.sequences import get_sequences

logger = logging.getLogger(__name__)


def save_eval_diagnostics(ev, log_dir: Path, args, sequences) -> Dict:
    """Write eval_diagnostics.json next to results.json: per-task success
    and steps, the host-time split, the dispatch count, the throughput curve
    and the per-subtask records."""
    per_task: dict = {}
    for r in ev.subtask_records:
        d = per_task.setdefault(r["task"], {"attempts": 0, "successes": 0, "steps_on_success": []})
        d["attempts"] += 1
        if r["success"]:
            d["successes"] += 1
            d["steps_on_success"].append(r["policy_steps"])
    for d in per_task.values():
        steps = d.pop("steps_on_success")
        d["sr"] = round(d["successes"] / max(d["attempts"], 1), 3)
        d["mean_policy_steps_on_success"] = round(float(np.mean(steps)), 1) if steps else None
    diag = {
        "num_sequences": len(sequences),
        "ep_len": args.ep_len,
        "n_envs": args.n_envs,
        "cohorts": len(ev.cohorts),
        "device_render": bool(args.device_render),
        "wall_clock_s": ev.wall_clock_s,
        "total_env_steps": int(ev.total_env_steps),
        "dispatches": int(ev.n_dispatches),
        "timings_s": dict(ev.timings),
        "throughput_curve": ev.throughput_curve,
        "per_task": dict(sorted(per_task.items(), key=lambda kv: kv[1]["sr"])),
        "subtask_records": ev.subtask_records,
    }
    (Path(log_dir) / "eval_diagnostics.json").write_text(json.dumps(diag, indent=1))
    return diag


def cohort_sizes(n_envs: int, cohorts: int) -> list:
    """``n_envs`` split into at most ``cohorts`` cohorts as evenly as possible."""
    n = max(1, min(cohorts, n_envs))
    return [n_envs // n + (1 if c < n_envs % n else 0) for c in range(n)]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--synthetic", action="store_true",
                   help="the flagship policy with random weights from the config's seed")
    p.add_argument("--train-dir", default=None,
                   help="a training run to load (not ported: the port has no checkpoints yet)")
    p.add_argument("--fake-env", action="store_true",
                   help="the interactive FakeCalvinEnv backend (the only one ported)")
    p.add_argument("--device-render", action="store_true",
                   help="render the fake env's frames on the device inside the policy step")
    p.add_argument("--n-envs", type=int, default=1, help="lockstep envs")
    p.add_argument("--cohorts", type=int, default=1,
                   help="cohorts of envs whose policy steps overlap with the others' host sims")
    p.add_argument("--num-sequences", type=int, default=harness.NUM_SEQUENCES)
    p.add_argument("--ep-len", type=int, default=harness.EP_LEN)
    p.add_argument("--log-dir", default="runs/torch_eval")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = p.parse_args(argv)
    if args.train_dir is not None:
        p.error("--train-dir is not ported yet: the port has no checkpoints (ROADMAP A4); "
                "use --synthetic")
    if not args.synthetic:
        p.error("--synthetic is required (the only policy source ported so far)")
    if not args.fake_env:
        p.error("--fake-env is required: the real CALVIN env is not ported")

    import torch

    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.data.device_transforms import camera_sizes
    from hulc2_torch.envs.calvin_wrapper import EnvFarm
    from hulc2_torch.envs.fake_env import FakeCalvinEnv
    from hulc2_torch.evaluation.batched_eval import PipelinedEvaluator
    from hulc2_torch.evaluation.tasks import TASK_NAMES
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.tools.annotations import VALIDATION_BANK
    from hulc2_torch.utils.clip_tokenizer import tokenize
    from hulc2_torch.utils.device import resolve_device, set_precision_flags

    t0 = time.time()
    device = resolve_device(args.device)
    set_precision_flags()
    cfg = flagship_config(args.overrides)
    sizes = camera_sizes(cfg["datamodule"]["transforms"])
    model = build_policy(cfg["model"], gripper_hw=sizes["rgb_gripper"], seed=cfg["seed"])
    model = model.to(device).eval()
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    sequences = get_sequences(args.num_sequences)
    # goals: BPE token ids of each task's canonical validation sentence
    lang = {t: np.asarray(tokenize([VALIDATION_BANK[t]])[0]) for t in TASK_NAMES}
    # render at the preset's sizes, so no resize is needed
    env_hw = dict(static_hw=sizes["rgb_static"], gripper_hw=sizes["rgb_gripper"])

    cohorts, shared_step = [], None
    for c, size in enumerate(cohort_sizes(args.n_envs, args.cohorts)):
        farm = EnvFarm([FakeCalvinEnv(render_obs=not args.device_render, **env_hw)
                        for _ in range(size)])
        # each cohort draws from its own generator, seeded from the config's seed
        agent = Hulc2Agent(model, cfg["datamodule"], seed=cfg["seed"] + 1 + c, n_envs=size,
                           fused_step=shared_step,
                           device_render=env_hw if args.device_render else None)
        shared_step = shared_step or agent._fused_step
        cohorts.append((farm, agent))
    # scored by the scene-obs oracle, the evaluator's default
    ev = PipelinedEvaluator(cohorts, lang, ep_len=args.ep_len)
    ev.partial_path = log_dir / "partial_results.json"
    results = ev.evaluate(sequences=sequences)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    merged = harness.print_and_save({"synthetic": results}, log_dir, sequences=sequences)
    diag = save_eval_diagnostics(ev, log_dir, args, sequences)
    logger.info("evaluation: %d chains, %d env steps in %.1f s (%.1f env-steps/s), %d dispatches, "
                "wall clock %.1f s", len(results), diag["total_env_steps"], diag["wall_clock_s"],
                diag["total_env_steps"] / max(diag["wall_clock_s"], 1e-9), diag["dispatches"],
                time.time() - t0)
    return merged


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main(sys.argv[1:])
