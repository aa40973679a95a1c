"""Policy evaluation harness: per-chain rollouts, success counting,
results.json aggregation.

Role-equivalent to the reference Evaluation class
(reference: hulc2/evaluation/evaluation.py:23-214) with the env/policy loop
abstracted behind a ``rollout_fn`` so the same harness drives PyBullet
single-env rollouts, batched env farms, or the symbolic fake env in tests.
The results.json schema (avg_seq_len, chain_sr 1..5, per-task success
counts, best-epoch entry) matches the reference (evaluation.py:78-132).

The port's copy of the scoring and results.json half of
``hulc2_tpu/evaluation/harness.py``; the single-env rollout loop and the
dataset single-step protocol are not ported.
"""
from __future__ import annotations

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
    """Merge per-checkpoint results into results.json with best-epoch ranking
    (reference: evaluation.py:78-132)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    sequences = sequences if sequences is not None else get_sequences(num_sequences)

    current: Dict[str, Dict] = {}
    ranking: Dict[str, float] = {}
    for epoch, results in total_results.items():
        data = summarize(results, sequences)
        ranking[str(epoch)] = data["avg_seq_len"]
        current[str(epoch)] = data
        logger.info("Epoch %s: avg_seq_len=%.3f chain_sr=%s", epoch, data["avg_seq_len"],
                    {k: f"{v*100:.1f}%" for k, v in data["chain_sr"].items()})

    previous: Dict = {}
    results_file = log_dir / "results.json"
    if results_file.is_file():
        previous = json.loads(results_file.read_text())
    merged = {**previous, **current}
    best = max(ranking, key=ranking.get)
    merged["best"] = {"epoch": best, **merged[best]}
    results_file.write_text(json.dumps(merged, indent=1))
    logger.info("Best model: epoch %s (avg_seq_len %.3f)", best, ranking[best])
    return merged
