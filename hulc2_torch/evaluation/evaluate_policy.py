"""CALVIN chain evaluation of a policy, on the fake env or the CALVIN simulator.

    python -m hulc2_torch.evaluation.evaluate_policy --train-dir RUN \\
        [--checkpoint STEP | --all-checkpoints] \\
        --fake-env [--device-render] [--n-envs 32] [--cohorts 4] \\
        [--aff-train-dir AFF_RUN [--aff-checkpoint STEP] [--aff-lang-embeddings NPY]] \\
        [--paraphrase-eval] [--single-step [--dataset-path DATASET]] \\
        [--num-sequences 1000] [--ep-len 360] [--log-dir DIR] [--device cuda|cpu]
    python -m hulc2_torch.evaluation.evaluate_policy --train-dir RUN --dataset-path DATASET \\
        [--n-envs 8 [--cohorts 2] [--process-envs]] [--heuristic-oracle] [other flags as above]
    python -m hulc2_torch.evaluation.evaluate_policy --synthetic --fake-env ... [key=value ...]

The port's counterpart of ``hulc2_tpu/evaluation/evaluate_policy.py:124``. ``--train-dir`` evaluates a
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
renders their frames on the device. A policy without the text tower
(``language_encoder: none``, ``--config-name cfg_low_level``) takes instead
each task's embedding from ``--dataset-path``'s
``validation/<lang_folder>/embeddings.npy``, the table its training data was
embedded with (``make_expert_dataset`` without ``--lang-tokens`` writes
one); such a policy has no paraphrase protocol. Success is scored by the
scene-obs oracle. The agents' draws come from generators seeded from the config's
``seed``. Writes ``results.json``, ``eval_diagnostics.json`` and snapshots in
``partial_results.json`` to ``--log-dir``.

Without ``--fake-env`` the chains run on the CALVIN simulator (calvin_env,
built from ``--dataset-path``'s recorded ``.hydra/merged_config.yaml``
through ``envs/calvin_wrapper.make_calvin_env``; the real branch of
``hulc2_tpu/evaluation/evaluate_policy.py:361-458``). Each task's goal comes
from that dataset's validation ``embeddings.npy``: its sentence's embedding,
or its token ids for a policy with the text tower. ``--n-envs`` above 1 runs
the batched evaluator over farms of simulators, in this process or, with
``--process-envs``, each in its own worker process
(``envs/process_farm.ProcessEnvFarm``; the workers never reach the card).
``--n-envs 1`` runs the serial chain loop (``harness.evaluate_policy``) with
one agent, whose ``reset(caption)`` runs the affordance approach in the
hierarchical mode. Scoring uses calvin_env's native oracle
(``envs/task_oracle.make_oracle``), or the scene-obs heuristic with
``--heuristic-oracle`` or when calvin_env has no oracle to import (with a
warning). A sentence detector's goals come from ``--aff-lang-embeddings``,
else from the dataset's table, and must have the detector's width. Without
calvin_env installed this branch raises its ``ImportError``; the recorded
contract in ``tests/mock_calvin_env`` stands in for it on hosts without the
simulator (put it first on ``PYTHONPATH``). One fault of the original is
repaired here: its batched real-env branch never set ``partial_path``, so a
long protocol on the simulator left no ``partial_results.json``.

``--aff-train-dir`` turns on the hierarchical (HULC++) mode with a detector
trained by ``python -m hulc2_torch.affordance.train_affordance`` (its newest
step, or ``--aff-checkpoint``): at every subtask start the detector predicts
where to go from the static frame and the task's canonical sentence, and a
PD approach drives the arm there before the policy takes over
(``batched_eval``). The log then reports the affordance predictions,
approaches and approach steps, also in the ``"hierarchical"`` block of
``eval_diagnostics.json``. A token-tower detector gets the task's
sentence as token ids; a detector over sentence embeddings (``text_tower``
false, e.g. ``rn18_pixel``) gets each task's embedding from
``--aff-lang-embeddings`` (an ``embeddings.npy``-style file), else the
``hash_embed`` of ``--dataset-path``'s canonical annotation at the
detector's width, the table the port's trainer embedded its labels with
(``hulc2_tpu/evaluation/evaluate_policy.py:292-305``); under
``--paraphrase-eval`` it keeps the canonical sentence's embedding, as in
JAX.

The other protocols of ``hulc2_tpu/evaluation/evaluate_policy.py``:
``--paraphrase-eval`` gives the policy, and the detector, each task's held-out
paraphrases (``tools/annotations.heldout_annotations``, never sampled for
training with ``--holdout-paraphrases``) in place of its canonical sentence,
chain ``i`` taking variant ``i % 4`` (on the simulator, batched only: the
serial loop takes one goal per task). ``--single-step`` scores one subtask
per chain: from the oracle-detected windows of ``--dataset-path``'s
validation split (``harness.dataset_singlestep_sequences``), or, without a
split, from the first subtask of each generated chain, with a warning.
``--all-checkpoints`` hands the run to ``run_multiple``, which evaluates
every saved step with the other flags and merges them into one
``results.json`` whose "best" is the step with the highest avg_seq_len.

Runs on the card unless ``--device cpu`` is given, and refuses to run without
one. The agents normalise robot_obs (and scene_obs) with the statistics the
run trained with (``loading.run_statistics``); JAX's fake-env agents get none
(``hulc2_tpu/evaluation/evaluate_policy.py:339``), so a proprio encoder
there sees raw robot_obs. A depth policy gets the envs' depth_static
(rendered on the device with ``--device-render``). ``eval_diagnostics.json``
also holds the kernels' launch counts of the process (``kernel_launches``)
and, with ``--process-envs``, what each env worker reported
(``env_workers``).
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from hulc2_torch.evaluation import harness
from hulc2_torch.evaluation.sequences import get_sequences

logger = logging.getLogger(__name__)


def load_lang_embeddings_file(f: Path):
    """An ``embeddings.npy``-style dict file -> ({annotation: embedding},
    {key: annotation}) (``hulc2_tpu/evaluation/evaluate_policy.py:35-41``)."""
    data = np.load(f, allow_pickle=True).item()
    return ({v["ann"][0]: np.asarray(v["emb"]).squeeze() for v in data.values()},
            {k: v["ann"][0] for k, v in data.items()})


def load_lang_embeddings(dataset_path: Path, lang_folder: str):
    """The validation split's sentence -> embedding table and its task ->
    sentence keys (reference: evaluation/utils.py:88-96 LangEmbeddings)."""
    return load_lang_embeddings_file(
        Path(dataset_path) / "validation" / lang_folder / "embeddings.npy")


def embedding_goals(dataset_path: Path, lang_folder: str) -> Dict[str, np.ndarray]:
    """Task -> the fp32 embedding of its canonical sentence, from the
    dataset's table (``evaluate_policy.py:267-275``)."""
    ann_emb, task_to_ann = load_lang_embeddings(dataset_path, lang_folder)
    return {t: np.asarray(ann_emb[a], np.float32) for t, a in task_to_ann.items()}


def sentence_detector_goals(dim: int, aff_lang_embeddings: Optional[str],
                            dataset_path: Optional[str], lang_folder: str):
    """(task -> the sentence detector's fp32 goal embedding, caption -> the
    same) from the ``--aff-lang-embeddings`` file, else ``hash_embed`` at
    ``dim`` of each task's canonical annotation in the dataset's table
    (``hulc2_tpu/evaluation/evaluate_policy.py:292-301``)."""
    from hulc2_torch.tools.auto_lang_annotator import hash_embed

    if aff_lang_embeddings is not None:
        ann_emb, task_to_ann = load_lang_embeddings_file(Path(aff_lang_embeddings))
        goals = {t: np.asarray(ann_emb[a], np.float32) for t, a in task_to_ann.items()}
    else:
        _, task_to_ann = load_lang_embeddings(dataset_path, lang_folder)
        goals = {t: hash_embed([a], dim)[0] for t, a in task_to_ann.items()}
    return goals, {task_to_ann[t]: v for t, v in goals.items()}


def save_eval_diagnostics(ev, log_dir: Path, args, sequences, extra: Optional[Dict] = None) -> Dict:
    """Write eval_diagnostics.json next to results.json: per-task success
    and steps, the host-time split, the dispatch count, the throughput curve,
    the per-subtask records, the kernels' launch counts and ``extra``."""
    from hulc2_torch import kernels

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
        "kernel_launches": dict(kernels.LAUNCHES),
        **(extra or {}),
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


class PolicyRollout:
    """``rollout_fn(env, subtask) -> bool`` of ``harness.evaluate_policy``:
    the agent's ``reset(caption)`` (the affordance approach in the
    hierarchical mode), then up to ``ep_len`` policy steps, the oracle
    checked after each (``hulc2_tpu/evaluation/evaluate_policy.py:103-121``;
    reference: manager_aff_lmp.py:26-79). ``goals`` maps each caption to the
    policy's goal. It keeps the counts ``save_eval_diagnostics`` reads: one
    record per subtask, the policy steps (``n_dispatches``), the approach's
    and the host time split."""

    def __init__(self, agent, oracle, task_to_annotation: Dict[str, str],
                 goals: Dict[str, np.ndarray], ep_len: int):
        self.agent = agent
        self.oracle = oracle
        self.task_to_annotation = task_to_annotation
        self.goals = goals
        self.ep_len = ep_len
        self.cohorts = [agent]  # one env, one agent
        self.subtask_records: List[dict] = []
        self.n_dispatches = 0
        self.timings = {"approach_s": 0.0, "policy_step_s": 0.0, "sim_step_s": 0.0}
        self.throughput_curve: List[dict] = []
        self.wall_clock_s = 0.0

    @property
    def n_aff_predictions(self) -> int:
        return self.agent.n_aff_predictions

    @property
    def n_approaches(self) -> int:
        return self.agent.n_approaches

    @property
    def n_approach_steps(self) -> int:
        return self.agent.n_move_steps

    @property
    def total_env_steps(self) -> int:
        return self.n_dispatches + self.agent.n_move_steps

    def __call__(self, env, subtask: str) -> bool:
        caption = self.task_to_annotation[subtask]
        moved = self.agent.n_move_steps
        t0 = time.perf_counter()
        self.agent.reset(caption)
        self.timings["approach_s"] += time.perf_counter() - t0
        start_info = env.get_info()
        goal = {"lang": self.goals[caption]}
        obs = env.get_obs()
        success, steps = False, 0
        while steps < self.ep_len and not success:
            t0 = time.perf_counter()
            action = self.agent.step(obs, goal)
            t1 = time.perf_counter()
            obs, _, _, info = env.step(action)
            self.timings["policy_step_s"] += t1 - t0
            self.timings["sim_step_s"] += time.perf_counter() - t1
            steps += 1
            success = subtask in self.oracle.get_task_info_for_set(start_info, info, [subtask])
        self.n_dispatches += steps
        self.subtask_records.append({"task": subtask, "success": success, "policy_steps": steps,
                                     "approach_steps": self.agent.n_move_steps - moved})
        return success


def make_policy_rollout_fn(agent, oracle, task_to_annotation, lang_embeddings,
                           ep_len: int) -> PolicyRollout:
    """``hulc2_tpu/evaluation/evaluate_policy.py:103``'s signature:
    ``lang_embeddings`` maps each caption to its goal."""
    return PolicyRollout(agent, oracle, task_to_annotation, lang_embeddings, ep_len)


def policy_has_text_tower(cfg: dict) -> bool:
    return (cfg["model"].get("language_encoder") or {}).get("_name_") == "clip_text"


def _tokens(sentences: Sequence[str]) -> list:
    """CLIP-BPE token ids of each sentence."""
    from hulc2_torch.utils.clip_tokenizer import tokenize

    return [np.asarray(t) for t in tokenize(list(sentences))]


def real_env_goals(p: argparse.ArgumentParser, args, cfg: dict, tower: bool, affordance):
    """The real env's goal tables from ``--dataset-path``'s validation
    ``embeddings.npy`` (``hulc2_tpu/evaluation/evaluate_policy.py:372-438``):
    (task -> sentence, task -> policy goal, task -> goal variants or None,
    task -> detector goal, caption -> detector input, task -> detector goal
    variants or None). A text-tower policy's goals are the sentences' token
    ids; a sentence detector's table comes from ``--aff-lang-embeddings``,
    else the dataset's, and must have the detector's width."""
    from hulc2_torch.tools.annotations import heldout_annotations

    ann_emb, task_to_ann = load_lang_embeddings(args.dataset_path, cfg["datamodule"]["lang_folder"])
    if tower:
        lang = dict(zip(task_to_ann, _tokens(list(task_to_ann.values()))))
        variants = ({t: _tokens(heldout_annotations(t)) for t in task_to_ann}
                    if args.paraphrase_eval else None)
    else:
        lang = {t: np.asarray(ann_emb[a], np.float32) for t, a in task_to_ann.items()}
        variants = None
    aff_lang = table = aff_variants = None
    if affordance is not None:
        if affordance.uses_tokens:
            aff_lang = lang if tower else dict(zip(task_to_ann, _tokens(list(task_to_ann.values()))))
            table = {task_to_ann[t]: v for t, v in aff_lang.items()}
            aff_variants = variants
        else:
            dim = affordance.model.lang_embed_dim
            aff_emb = (load_lang_embeddings_file(Path(args.aff_lang_embeddings))[0]
                       if args.aff_lang_embeddings else ann_emb)
            width = np.asarray(next(iter(aff_emb.values()))).shape[-1]
            if width != dim:
                p.error(f"affordance language embeddings are {width}-d but the affordance model "
                        f"expects {dim}-d — pass --aff-lang-embeddings with a table produced by "
                        "the affordance model's own encoder")
            aff_lang = {t: np.asarray(aff_emb[a], np.float32) for t, a in task_to_ann.items()}
            table = {a: np.asarray(e, np.float32) for a, e in aff_emb.items()}
    return task_to_ann, lang, variants, aff_lang, table, aff_variants


def evaluate_real_env(args, cfg: dict, model, stats, affordance, goals, sequences,
                      log_dir: Path):
    """The chains on the CALVIN simulator: batched over farms of ``--n-envs``
    envs (in worker processes with ``--process-envs``), or one env through
    the serial loop. Returns (results, the evaluator or the serial rollout,
    extra diagnostics)."""
    from functools import partial

    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.envs.calvin_wrapper import EnvFarm, make_wrapped_calvin_env
    from hulc2_torch.envs.process_farm import ProcessEnvFarm
    from hulc2_torch.envs.task_oracle import make_oracle
    from hulc2_torch.evaluation.batched_eval import PipelinedEvaluator

    task_to_ann, lang, variants, aff_lang, table, aff_variants = goals
    oracle = make_oracle(real_env=True, force_heuristic=args.heuristic_oracle)
    extra = {"oracle": type(oracle).__name__}
    if args.n_envs == 1:
        env = make_wrapped_calvin_env(args.dataset_path)
        agent = Hulc2Agent(model, cfg["datamodule"], seed=cfg["seed"] + 1, stats=stats, env=env,
                           affordance=affordance)
        rollout = make_policy_rollout_fn(agent, oracle, task_to_ann,
                                         {task_to_ann[t]: v for t, v in lang.items()}, args.ep_len)
        t0 = time.perf_counter()
        results = harness.evaluate_policy(rollout, env, sequences=sequences)
        rollout.wall_clock_s = time.perf_counter() - t0
        return results, rollout, extra
    cohorts, shared_step = [], None
    try:
        for c, size in enumerate(cohort_sizes(args.n_envs, args.cohorts)):
            if args.process_envs:
                farm = ProcessEnvFarm([partial(make_wrapped_calvin_env, args.dataset_path)] * size)
            else:
                farm = EnvFarm([make_wrapped_calvin_env(args.dataset_path) for _ in range(size)])
            agent = Hulc2Agent(model, cfg["datamodule"], seed=cfg["seed"] + 1 + c, n_envs=size,
                               fused_step=shared_step, stats=stats)
            shared_step = shared_step or agent._fused_step
            cohorts.append((farm, agent))
        if args.process_envs:
            extra["env_workers"] = [w for farm, _ in cohorts for w in farm.worker_info()]
        ev = PipelinedEvaluator(cohorts, lang, ep_len=args.ep_len, oracle=oracle,
                                affordance=affordance, aff_lang_embeddings=aff_lang,
                                lang_variants=variants, aff_lang_variants=aff_variants)
        ev.partial_path = log_dir / "partial_results.json"
        results = ev.evaluate(sequences=sequences)
    finally:
        for farm, _ in cohorts:
            if hasattr(farm, "close"):
                farm.close()
    return results, ev, extra


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
                   help="the interactive FakeCalvinEnv backend (default: the CALVIN simulator, "
                        "which needs calvin_env and --dataset-path)")
    p.add_argument("--device-render", action="store_true",
                   help="render the fake env's frames on the device inside the policy step")
    p.add_argument("--n-envs", type=int, default=1, help="lockstep envs")
    p.add_argument("--cohorts", type=int, default=1,
                   help="cohorts of envs whose policy steps overlap with the others' host sims")
    p.add_argument("--process-envs", action="store_true",
                   help="each simulator in its own worker process, so that the envs step in "
                        "parallel on host cores (the real env, --n-envs above 1)")
    p.add_argument("--heuristic-oracle", action="store_true",
                   help="score the real env with the scene-obs heuristic oracle even when "
                        "calvin_env's native oracle is available")
    p.add_argument("--num-sequences", type=int, default=harness.NUM_SEQUENCES)
    p.add_argument("--ep-len", type=int, default=harness.EP_LEN)
    p.add_argument("--log-dir", default=None,
                   help="output dir (default: <train-dir>/evaluation, or runs/torch_eval)")
    p.add_argument("--aff-train-dir", default=None,
                   help="an affordance run dir of the port: turns on the hierarchical mode")
    p.add_argument("--aff-checkpoint", type=int, default=None,
                   help="with --aff-train-dir: the affordance step to load (default: the newest)")
    p.add_argument("--aff-lang-embeddings", default=None,
                   help="with --aff-train-dir: an embeddings.npy-style file whose entries give a "
                        "sentence detector each task's goal embedding")
    p.add_argument("--single-step", action="store_true",
                   help="evaluate only one subtask per chain: the per-task success-rate "
                        "protocol (chain_sr 1 is the overall SR)")
    p.add_argument("--dataset-path", default=None,
                   help="a dataset root: the real env's render config and goal table; with "
                        "--single-step its validation split gives the initial states "
                        "(oracle-detected task windows); for a policy without the text tower "
                        "its embeddings.npy gives the goals")
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
        check_run_dir(p, Path(args.aff_train_dir), args.aff_checkpoint, "--aff-train-dir",
                       "--aff-checkpoint", "aff_detection")
    elif args.aff_checkpoint is not None or args.aff_lang_embeddings is not None:
        p.error("--aff-checkpoint and --aff-lang-embeddings need --aff-train-dir")
    if args.fake_env and args.process_envs:
        p.error("--process-envs runs CALVIN simulators in worker processes: drop --fake-env")
    if not args.fake_env:
        if args.dataset_path is None:
            p.error("--dataset-path is required without --fake-env: the CALVIN env is built from "
                    "its recorded render config and the goals come from its embeddings.npy")
        if args.device_render:
            p.error("--device-render renders the fake env's frames: it needs --fake-env")
        if args.process_envs and args.n_envs < 2:
            p.error("--process-envs steps a farm of envs: it needs --n-envs above 1")
        if args.paraphrase_eval and args.n_envs == 1:
            p.error("--paraphrase-eval rotates goals over the chains of the batched evaluator: "
                    "on the CALVIN env it needs --n-envs above 1")

    import torch

    from hulc2_torch.agents.hulc2_agent import Hulc2Agent
    from hulc2_torch.configs.flagship import flagship_config
    from hulc2_torch.core.checkpoint import load_run_config
    from hulc2_torch.data.device_transforms import camera_sizes
    from hulc2_torch.envs.calvin_wrapper import EnvFarm
    from hulc2_torch.envs.fake_env import FakeCalvinEnv
    from hulc2_torch.envs.task_oracle import make_oracle
    from hulc2_torch.evaluation.batched_eval import PipelinedEvaluator
    from hulc2_torch.evaluation.loading import load_affordance, load_policy, run_statistics
    from hulc2_torch.evaluation.tasks import TASK_NAMES
    from hulc2_torch.models.build import build_policy_for
    from hulc2_torch.tools.annotations import VALIDATION_BANK, heldout_annotations
    from hulc2_torch.utils.device import resolve_device, set_precision_flags

    cfg = (load_run_config(Path(args.train_dir)) if args.train_dir is not None
           else flagship_config(args.overrides))
    tower = policy_has_text_tower(cfg)
    if args.paraphrase_eval and not tower:
        p.error("--paraphrase-eval needs a policy with the in-graph text tower "
                "(model.language_encoder clip_text): a policy without one cannot encode "
                "sentences it never saw")
    if args.fake_env:
        if tower and args.dataset_path is not None and not args.single_step:
            p.error("--dataset-path without --single-step gives a policy without the text "
                    "tower its goal embeddings: this policy tokenizes its goals")
        if not tower and args.dataset_path is None:
            p.error("a policy without the text tower takes its goals from --dataset-path's "
                    "validation/<lang_folder>/embeddings.npy")
        if args.aff_train_dir is not None and args.aff_lang_embeddings is None and tower and \
                not load_run_config(Path(args.aff_train_dir))["aff_detection"].get("text_tower"):
            p.error("a detector over sentence embeddings with a text-tower policy takes its "
                    "goals from --aff-lang-embeddings")
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
    stats = None
    if args.train_dir is not None:
        model, cfg, step = load_policy(args.train_dir, args.checkpoint)
        stats = run_statistics(args.train_dir, cfg)
        results_key = str(args.checkpoint) if args.checkpoint is not None else "latest"
        log_dir = Path(args.log_dir or Path(args.train_dir) / "evaluation")
        logger.info("policy: step %d of %s", step, args.train_dir)
    else:
        model = build_policy_for(cfg)
        results_key = "synthetic"
        log_dir = Path(args.log_dir or "runs/torch_eval")
    model = model.to(device).eval()
    log_dir.mkdir(parents=True, exist_ok=True)
    affordance = None
    if args.aff_train_dir is not None:
        affordance = load_affordance(args.aff_train_dir, args.aff_checkpoint, device,
                                     seed=cfg["seed"])

    if not args.fake_env:
        goals = real_env_goals(p, args, cfg, tower, affordance)
        if affordance is not None:
            affordance.lang_table = goals[4]
        results, ev, extra = evaluate_real_env(args, cfg, model, stats, affordance, goals,
                                               sequences, log_dir)
    else:
        # goals: BPE token ids of each task's canonical validation sentence,
        # for the policy's and the detector's text towers alike; the
        # paraphrase protocol swaps in the held-out sentences. A policy
        # without a tower gets the dataset's embedding of the same sentence.
        lang = dict(zip(TASK_NAMES, _tokens([VALIDATION_BANK[t] for t in TASK_NAMES])))
        heldout = {t: _tokens(heldout_annotations(t)) for t in TASK_NAMES}
        variants = heldout if args.paraphrase_eval else None
        if not tower:
            lang = embedding_goals(args.dataset_path, cfg["datamodule"]["lang_folder"])
        aff_lang, aff_variants = lang, None
        if affordance is not None:
            if affordance.uses_tokens:
                # the captions the detector can be asked by name: canonical and held out
                aff_lang = dict(zip(TASK_NAMES,
                                    _tokens([VALIDATION_BANK[t] for t in TASK_NAMES])))
                table = {VALIDATION_BANK[t]: aff_lang[t] for t in TASK_NAMES}
                for t in TASK_NAMES:
                    table.update(zip(heldout_annotations(t), heldout[t]))
                aff_variants = variants
            else:
                aff_lang, table = sentence_detector_goals(
                    affordance.model.lang_embed_dim, args.aff_lang_embeddings, args.dataset_path,
                    cfg["datamodule"]["lang_folder"])
                if any(v.shape != (affordance.model.lang_embed_dim,) for v in aff_lang.values()):
                    p.error(f"the detector takes {affordance.model.lang_embed_dim}-d sentence "
                            f"embeddings; the goal table's are "
                            f"{next(iter(aff_lang.values())).shape}")
            affordance.lang_table = table
        # render at the preset's sizes, so no resize is needed
        sizes = camera_sizes(cfg["datamodule"]["transforms"])
        env_hw = dict(static_hw=sizes["rgb_static"], gripper_hw=sizes["rgb_gripper"])
        cohorts, shared_step = [], None
        for c, size in enumerate(cohort_sizes(args.n_envs, args.cohorts)):
            farm = EnvFarm([FakeCalvinEnv(render_obs=not args.device_render, **env_hw)
                            for _ in range(size)])
            # each cohort draws from its own generator, seeded from the config's seed
            agent = Hulc2Agent(model, cfg["datamodule"], seed=cfg["seed"] + 1 + c, n_envs=size,
                               fused_step=shared_step,
                               device_render=env_hw if args.device_render else None, stats=stats)
            shared_step = shared_step or agent._fused_step
            cohorts.append((farm, agent))
        ev = PipelinedEvaluator(cohorts, lang, ep_len=args.ep_len,
                                oracle=make_oracle(real_env=False), affordance=affordance,
                                aff_lang_embeddings=aff_lang, lang_variants=variants,
                                aff_lang_variants=aff_variants)
        ev.partial_path = log_dir / "partial_results.json"
        results = ev.evaluate(sequences=sequences)
        extra = {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    merged = harness.print_and_save({results_key: results}, log_dir, sequences=sequences)
    diag = save_eval_diagnostics(ev, log_dir, args, sequences, extra)
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
