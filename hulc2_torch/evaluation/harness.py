"""Policy evaluation harness: per-chain rollouts, success counting,
results.json aggregation.

Role-equivalent to the reference Evaluation class
(reference: hulc2/evaluation/evaluation.py:23-214) with the env/policy loop
abstracted behind a ``rollout_fn`` so the same harness drives PyBullet
single-env rollouts, batched env farms, or the symbolic fake env in tests.
The results.json schema (avg_seq_len, chain_sr 1..5, per-task success
counts, best-epoch entry) matches the reference (evaluation.py:78-132).

The port's copy of ``hulc2_tpu/evaluation/harness.py`` without the
single-env rollout loop (every port evaluation runs the batched evaluator).
Two faults of the original are repaired: ``print_and_save`` ranks "best" over
every step in the merged results.json, not only the steps of the current
call, so a sweep that evaluates one checkpoint per call still names the best
of them; and it merges under a file lock, so parallel workers lose no step.

    python -m hulc2_torch.evaluation.harness -f RUN/evaluation/results.json
"""
from __future__ import annotations

import fcntl
import json
import logging
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from hulc2_torch.evaluation.sequences import get_sequences

logger = logging.getLogger(__name__)

EP_LEN = 360  # step budget per subtask (reference: evaluate_policy.py:73)
NUM_SEQUENCES = 1000  # (reference: evaluate_policy.py:74)


def count_success(results: Sequence[int]) -> List[float]:
    """Chain success rates for >= i completed subtasks, i = 1..5
    (reference: evaluation.py:69-76)."""
    n = len(results)
    return [sum(r >= i for r in results) / n for i in range(1, 6)]


def singlestep_sequences(sequences):
    """Truncate each chain to its first subtask: the single-step protocol
    without a dataset. Same scoring (``count_success`` index 0 is the overall
    SR, ``per_task_breakdown`` the per-task table), but the initial states
    come from the chain generator, not from recorded validation episodes;
    ``dataset_singlestep_sequences`` matches the reference's distribution."""
    return [(state, chain[:1]) for state, chain in sequences]


def dataset_singlestep_sequences(val_dir, max_per_task: int = 8):
    """The reference single-step protocol's initial states
    (evaluate_policy_singlestep.py:22-41): per task, up to ``max_per_task``
    windows of the validation split where the scene-obs oracle detects that
    task, each started from the window's first recorded (robot_obs,
    scene_obs). Returns (initial_state, (task,)) pairs; the evaluators pass
    explicit states through."""
    from hulc2_torch.data.episode_index import load_ep_start_end_ids
    from hulc2_torch.data.frame_store import NpzFrameStore
    from hulc2_torch.tools.auto_lang_annotator import detect_task_windows

    val_dir = Path(val_dir)
    ep_ids = load_ep_start_end_ids(val_dir, "validation")
    store = NpzFrameStore(val_dir, ["scene_obs", "robot_obs"])
    by_task: Dict[str, List[int]] = {}
    for hit in detect_task_windows(store, ep_ids):
        by_task.setdefault(hit["task"], []).append(int(hit["indx"][0]))
    seqs = []
    for task in sorted(by_task):
        for start in by_task[task][:max_per_task]:
            f = store.load_frame(start)
            seqs.append(({"robot_obs": np.asarray(f["robot_obs"], np.float64),
                          "scene_obs": np.asarray(f["scene_obs"], np.float64)}, (task,)))
    logger.info("single-step: %d jobs over %d tasks from %s", len(seqs), len(by_task), val_dir)
    return seqs


def per_task_breakdown(results: Sequence[int], sequences) -> Dict[str, Dict[str, int]]:
    """Per-task success/total counts over attempted subtasks
    (reference: evaluation.py:96-112)."""
    ok: Counter = Counter()
    attempted: Counter = Counter()
    for n_done, (_, chain) in zip(results, sequences):
        for t in chain[:n_done]:
            ok[t] += 1
            attempted[t] += 1
        if n_done < len(chain):
            attempted[chain[n_done]] += 1
    return {t: {"success": ok[t], "total": attempted[t]} for t in attempted}


def summarize(results: Sequence[int], sequences) -> Dict:
    return {
        "avg_seq_len": float(np.mean(results)),
        "chain_sr": {i + 1: sr for i, sr in enumerate(count_success(results))},
        "task_info": per_task_breakdown(results, sequences),
    }


def print_and_save(
    total_results: Dict[str, List[int]],
    log_dir,
    num_sequences: int = NUM_SEQUENCES,
    sequences=None,
) -> Dict:
    """Merge per-checkpoint results into results.json and name the best
    step by avg_seq_len over every step in the merged file (reference:
    evaluation.py:78-132). On a tie the step first in the file wins."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    sequences = sequences if sequences is not None else get_sequences(num_sequences)

    current: Dict[str, Dict] = {}
    for epoch, results in total_results.items():
        data = summarize(results, sequences)
        current[str(epoch)] = data
        logger.info("Epoch %s: avg_seq_len=%.3f chain_sr=%s", epoch, data["avg_seq_len"],
                    {k: f"{v*100:.1f}%" for k, v in data["chain_sr"].items()})

    results_file = log_dir / "results.json"
    # run_multiple's worker processes merge into one file: the read, merge
    # and write hold an exclusive lock, so no worker's steps are lost
    with open(log_dir / ".results.json.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        previous = json.loads(results_file.read_text()) if results_file.is_file() else {}
        merged = {**previous, **current}
        best = _best_epoch(merged)
        merged["best"] = {"epoch": best, **merged[best]}
        results_file.write_text(json.dumps(merged, indent=1))
    logger.info("Best model: epoch %s (avg_seq_len %.3f)", best, merged[best]["avg_seq_len"])
    return merged


def _best_epoch(results: Dict) -> str:
    """The step with the highest avg_seq_len among a results.json's entries."""
    epochs = {k: v["avg_seq_len"] for k, v in results.items()
              if k != "best" and isinstance(v, dict) and "avg_seq_len" in v}
    return max(epochs, key=epochs.get)


def best_eval_model(results_file) -> str:
    """Print the best step of a results.json by avg_seq_len, its avg_seq_len
    and its chain SRs (reference:
    hulc2/affordance/scripts/get_best_eval_model.py:10-16)."""
    data = json.loads(Path(results_file).read_text())
    best = _best_epoch(data)
    print(best)
    print(data[best]["avg_seq_len"])
    print(data[best]["chain_sr"])
    return best


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="pick the best epoch from a results.json")
    p.add_argument("-f", "--file", required=True)
    best_eval_model(p.parse_args().file)
