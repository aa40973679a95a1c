"""CALVIN chain evaluation of a policy on the interactive fake env.

    python -m hulc2_torch.evaluation.evaluate_policy --train-dir RUN \\
        [--checkpoint STEP | --all-checkpoints] \\
        --fake-env [--device-render] [--n-envs 32] [--cohorts 4] \\
        [--aff-train-dir AFF_RUN [--aff-checkpoint STEP]] \\
        [--paraphrase-eval] [--single-step [--dataset-path DATASET]] \\
        [--num-sequences 1000] [--ep-len 360] [--log-dir DIR] [--device cuda|cpu]
    python -m hulc2_torch.evaluation.evaluate_policy --synthetic --fake-env ... [key=value ...]

The port's counterpart of the fake-env branch of
``hulc2_tpu/evaluation/evaluate_policy.py:124``. ``--train-dir`` evaluates a
policy trained by ``python -m hulc2_torch.training``: the model is built from
the run's ``config.json`` and loaded from its newest checkpoint, or the step
``--checkpoint`` names; results go under the key "latest" or that step, in
``<train-dir>/evaluation`` unless ``--log-dir`` says otherwise. The fake
envs render at the run's transform preset's sizes. ``--synthetic`` evaluates
the flagship policy (``configs/flagship.py`` with dotted ``key=value``
overrides) with random weights from ``build_policy(cfg, seed)``, the
convention of ``python -m hulc2_torch.training --synthetic``. The goal of each subtask is the
BPE token ids of the task's canonical sentence, which the policy's text tower
encodes on every step. ``--n-envs`` fake envs run in lockstep in ``--cohorts``
cohorts whose policy steps overlap (``batched_eval.PipelinedEvaluator``);
with ``--device-render`` the envs keep only their state and the policy step
renders their frames on the device. Success is scored by the scene-obs
oracle. The agents' draws come from generators seeded from the config's
``seed``. Writes ``results.json``, ``eval_diagnostics.json`` and snapshots in
``partial_results.json`` to ``--log-dir``.

``--aff-train-dir`` turns on the hierarchical (HULC++) mode with a detector
trained by ``python -m hulc2_torch.affordance.train_affordance`` (its newest
step, or ``--aff-checkpoint``): at every subtask start the detector predicts
where to go from the static frame and the task's canonical sentence, and a
PD approach drives the arm there before the policy takes over
(``batched_eval``). The log then reports the affordance predictions,
approaches and approach steps, also in the ``"hierarchical"`` block of
``eval_diagnostics.json``.

The other protocols of ``hulc2_tpu/evaluation/evaluate_policy.py``:
``--paraphrase-eval`` gives the policy, and the detector, each task's held-out
paraphrases (``tools/annotations.heldout_annotations``, never sampled for
training with ``--holdout-paraphrases``) in place of its canonical sentence,
chain ``i`` taking variant ``i % 4``. ``--single-step`` scores one subtask
per chain: from the oracle-detected windows of ``--dataset-path``'s
validation split (``harness.dataset_singlestep_sequences``), or, without a
split, from the first subtask of each generated chain, with a warning.
``--all-checkpoints`` hands the run to ``run_multiple``, which evaluates
every saved step with the other flags and merges them into one
``results.json`` whose "best" is the step with the highest avg_seq_len.

Runs on the card unless ``--device cpu`` is given, and refuses to run without
one. Not ported yet: the real CALVIN env and the process env farm. As in the
JAX package, the fake-env agents normalize no proprioception with the dataset
statistics (the flagship has no proprio encoder, so its actions do not
depend on it).
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
        "paraphrase_eval": bool(args.paraphrase_eval),
        "wall_clock_s": ev.wall_clock_s,
        "total_env_steps": int(ev.total_env_steps),
        "dispatches": int(ev.n_dispatches),
        "timings_s": dict(ev.timings),
        "throughput_curve": ev.throughput_curve,
        "hierarchical": {
            "aff_predictions": ev.n_aff_predictions,
            "approaches": ev.n_approaches,
            "approach_steps": ev.n_approach_steps,
        },
        "per_task": dict(sorted(per_task.items(), key=lambda kv: kv[1]["sr"])),
        "subtask_records": ev.subtask_records,
    }
    (Path(log_dir) / "eval_diagnostics.json").write_text(json.dumps(diag, indent=1))
    return diag


def cohort_sizes(n_envs: int, cohorts: int) -> list:
    """``n_envs`` split into at most ``cohorts`` cohorts as evenly as possible."""
    n = max(1, min(cohorts, n_envs))
    return [n_envs // n + (1 if c < n_envs % n else 0) for c in range(n)]


def check_run_dir(p: argparse.ArgumentParser, run_dir: Path, step: Optional[int],
                   flag: str = "--train-dir", step_flag: str = "--checkpoint",
                   section: str = "model") -> None:
    """Refuse, through the parser, a run dir the port cannot load: one
    without a config holding ``section`` or without checkpoints."""
    from hulc2_torch.core.checkpoint import CheckpointManager, load_run_config

    steps = CheckpointManager(run_dir).all_steps()
    if not (run_dir / "config.json").is_file():
        p.error(f"{flag} {run_dir}: no config.json (not a training run of the port)")
    if section not in load_run_config(run_dir):
        p.error(f"{flag} {run_dir}: its config.json has no {section!r} section")
    if not steps:
        p.error(f"{flag} {run_dir}: no checkpoints under saved_models/")
    if step is not None and step not in steps:
        p.error(f"{step_flag} {step}: the run has steps {steps}")


def policy_has_text_tower(cfg: dict) -> bool:
    return (cfg["model"].get("language_encoder") or {}).get("_name_") == "clip_text"


def _tokens(sentences: Sequence[str]) -> list:
    from hulc2_torch.utils.clip_tokenizer import tokenize

    return [np.asarray(t) for t in tokenize(list(sentences))]


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--synthetic", action="store_true",
                   help="the flagship policy with random weights from the config's seed")
    p.add_argument("--train-dir", default=None,
                   help="a training run dir of the port (config.json + saved_models) to load")
    p.add_argument("--checkpoint", type=int, default=None,
                   help="with --train-dir: the step to load (default: the newest)")
    p.add_argument("--all-checkpoints", action="store_true",
                   help="with --train-dir: evaluate every checkpoint of the run, one after "
                        "another (run_multiple); the rest of the flags apply to each")
    p.add_argument("--fake-env", action="store_true",
                   help="the interactive FakeCalvinEnv backend (the only one ported)")
    p.add_argument("--device-render", action="store_true",
                   help="render the fake env's frames on the device inside the policy step")
    p.add_argument("--n-envs", type=int, default=1, help="lockstep envs")
    p.add_argument("--cohorts", type=int, default=1,
                   help="cohorts of envs whose policy steps overlap with the others' host sims")
    p.add_argument("--num-sequences", type=int, default=harness.NUM_SEQUENCES)
    p.add_argument("--ep-len", type=int, default=harness.EP_LEN)
    p.add_argument("--log-dir", default=None,
                   help="output dir (default: <train-dir>/evaluation, or runs/torch_eval)")
    p.add_argument("--aff-train-dir", default=None,
                   help="an affordance run dir of the port: turns on the hierarchical mode")
    p.add_argument("--aff-checkpoint", type=int, default=None,
                   help="with --aff-train-dir: the affordance step to load (default: the newest)")
    p.add_argument("--single-step", action="store_true",
                   help="evaluate only one subtask per chain: the per-task success-rate "
                        "protocol (chain_sr 1 is the overall SR)")
    p.add_argument("--dataset-path", default=None,
                   help="with --single-step: a dataset root whose validation split gives the "
                        "initial states (oracle-detected task windows)")
    p.add_argument("--paraphrase-eval", action="store_true",
                   help="goals are each task's held-out paraphrases, rotated over the chains "
                        "(needs a policy with the in-graph text tower)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*",
                   help="dotted key=value config overrides (with --synthetic)")
    args = p.parse_args(argv)
    if args.synthetic == (args.train_dir is not None):
        p.error("give exactly one policy source: --train-dir RUN or --synthetic")
    if args.train_dir is not None:
        check_run_dir(p, Path(args.train_dir), args.checkpoint)
        if args.overrides:
            p.error("config overrides apply to --synthetic only: a run's config is its own")
    if args.all_checkpoints:
        if args.train_dir is None or args.checkpoint is not None:
            p.error("--all-checkpoints evaluates every step of a --train-dir run; "
                    "--checkpoint STEP evaluates one")
        from hulc2_torch.evaluation import run_multiple

        rest = [a for a in (argv if argv is not None else sys.argv[1:]) if a != "--all-checkpoints"]
        return run_multiple.main(rest)
    if args.aff_train_dir is not None:
        from hulc2_torch.affordance.train_affordance import unported
        from hulc2_torch.core.checkpoint import load_run_config

        check_run_dir(p, Path(args.aff_train_dir), args.aff_checkpoint, "--aff-train-dir",
                       "--aff-checkpoint", "aff_detection")
        reason = unported(load_run_config(Path(args.aff_train_dir))["aff_detection"])
        if reason:
            p.error(f"--aff-train-dir {args.aff_train_dir}: {reason}")
    elif args.aff_checkpoint is not None:
        p.error("--aff-checkpoint needs --aff-train-dir")
    if not args.fake_env:
        p.error("--fake-env is required: the real CALVIN env is not ported")
    if args.dataset_path is not None and not args.single_step:
        p.error("--dataset-path is read by --single-step only: the port's policies "
                "tokenize their goals")

    import torch

    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.core.checkpoint import load_run_config
    from hulc2_torch.data.device_transforms import camera_sizes
    from hulc2_torch.envs.calvin_wrapper import EnvFarm
    from hulc2_torch.envs.fake_env import FakeCalvinEnv
    from hulc2_torch.evaluation.batched_eval import PipelinedEvaluator
    from hulc2_torch.evaluation.loading import load_affordance, load_policy
    from hulc2_torch.evaluation.tasks import TASK_NAMES
    from hulc2_torch.models.build import build_policy
    from hulc2_torch.tools.annotations import VALIDATION_BANK, heldout_annotations
    from hulc2_torch.utils.device import resolve_device, set_precision_flags

    cfg = (load_run_config(Path(args.train_dir)) if args.train_dir is not None
           else flagship_config(args.overrides))
    if args.paraphrase_eval and not policy_has_text_tower(cfg):
        p.error("--paraphrase-eval needs a policy with the in-graph text tower "
                "(model.language_encoder clip_text): a policy without one cannot encode "
                "sentences it never saw")
    val_dir = Path(args.dataset_path) / "validation" if args.dataset_path else None
    if args.single_step and val_dir is not None and val_dir.is_dir():
        # the reference protocol: initial states of oracle-detected windows
        # of the validation episodes
        sequences = harness.dataset_singlestep_sequences(val_dir)
        if not sequences:
            p.error(f"--dataset-path {args.dataset_path}: no task windows in {val_dir}")
    else:
        sequences = get_sequences(args.num_sequences)
        if args.single_step:
            logger.warning("--single-step without a dataset validation split: using the first "
                           "subtask of the chain generator's chains (an approximation of the "
                           "reference's recorded-episode initial states)")
            sequences = harness.singlestep_sequences(sequences)

    t0 = time.time()
    device = resolve_device(args.device)
    set_precision_flags()
    sizes = camera_sizes(cfg["datamodule"]["transforms"])
    if args.train_dir is not None:
        model, cfg, step = load_policy(args.train_dir, args.checkpoint)
        results_key = str(args.checkpoint) if args.checkpoint is not None else "latest"
        log_dir = Path(args.log_dir or Path(args.train_dir) / "evaluation")
        logger.info("policy: step %d of %s", step, args.train_dir)
    else:
        model = build_policy(cfg["model"], gripper_hw=sizes["rgb_gripper"], seed=cfg["seed"])
        results_key = "synthetic"
        log_dir = Path(args.log_dir or "runs/torch_eval")
    model = model.to(device).eval()
    log_dir.mkdir(parents=True, exist_ok=True)
    # goals: BPE token ids of each task's canonical validation sentence, for
    # the policy's and the detector's text towers alike; the paraphrase
    # protocol swaps in the held-out sentences
    lang = dict(zip(TASK_NAMES, _tokens([VALIDATION_BANK[t] for t in TASK_NAMES])))
    heldout = {t: _tokens(heldout_annotations(t)) for t in TASK_NAMES}
    variants = heldout if args.paraphrase_eval else None
    affordance = None
    if args.aff_train_dir is not None:
        # the captions the detector can be asked by name: canonical and held out
        table = {VALIDATION_BANK[t]: lang[t] for t in TASK_NAMES}
        for t in TASK_NAMES:
            table.update(zip(heldout_annotations(t), heldout[t]))
        affordance = load_affordance(args.aff_train_dir, args.aff_checkpoint, device,
                                     seed=cfg["seed"], lang_table=table)
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
    ev = PipelinedEvaluator(cohorts, lang, ep_len=args.ep_len, affordance=affordance,
                            aff_lang_embeddings=lang, lang_variants=variants,
                            aff_lang_variants=variants if affordance is not None else None)
    ev.partial_path = log_dir / "partial_results.json"
    results = ev.evaluate(sequences=sequences)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    merged = harness.print_and_save({results_key: results}, log_dir, sequences=sequences)
    diag = save_eval_diagnostics(ev, log_dir, args, sequences)
    if affordance is not None:
        logger.info("hierarchical mode: %d affordance predictions, %d approaches, "
                    "%d approach steps", ev.n_aff_predictions, ev.n_approaches,
                    ev.n_approach_steps)
    logger.info("evaluation: %d chains, %d env steps in %.1f s (%.1f env-steps/s), %d dispatches, "
                "wall clock %.1f s", len(results), diag["total_env_steps"], diag["wall_clock_s"],
                diag["total_env_steps"] / max(diag["wall_clock_s"], 1e-9), diag["dispatches"],
                time.time() - t0)
    return merged


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main(sys.argv[1:])
