"""Deterministic CALVIN evaluation-chain generation.

Behavior-identical to the reference generator
(reference: hulc2/evaluation/multistep_sequences.py:292-383): the same 192
filtered initial symbolic states, the same ``np.array_split`` workload split,
the same per-state legacy-NumPy RNG stream (``np.random.seed(i)`` then
rejection-sampled ``np.random.choice`` draws over the task registry in its
canonical order), and the same final seeded shuffle — so chain i of N is
bit-identical to the reference benchmark's chain i.

The reference fans this out over a ProcessPoolExecutor; each state's stream is
independent (seeded by its index), so we use threads/processes freely without
changing results.

The port's copy of ``hulc2_tpu/evaluation/sequences.py``; it imports no
torch, because its pool workers import it.
"""
from __future__ import annotations

import contextlib
import functools
import os
from concurrent.futures import ProcessPoolExecutor
from itertools import product
from typing import Dict, List, Tuple

import numpy as np

from hulc2_torch.evaluation.tasks import TASK_CATEGORIES, TASK_NAMES, is_chain_valid, successor_states

CHAIN_LEN = 5

POSSIBLE_CONDITIONS = {
    "led": [0, 1],
    "lightbulb": [0, 1],
    "slider": ["right", "left"],
    "drawer": ["closed", "open"],
    "red_block": ["table", "slider_right", "slider_left"],
    "blue_block": ["table", "slider_right", "slider_left"],
    "pink_block": ["table", "slider_right", "slider_left"],
    "grasped": [0],
}


@contextlib.contextmanager
def temp_seed(seed: int):
    """Temporarily seed the global legacy NumPy RNG
    (reference: evaluation/utils.py:137-144)."""
    st = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(st)


def enumerate_initial_states() -> List[Dict]:
    """The 192 admissible initial states: 1-2 blocks on the table and at most
    one block per slider compartment (reference: multistep_sequences.py:353-366)."""
    keys = list(POSSIBLE_CONDITIONS)

    def admissible(vals) -> bool:
        blocks = list(vals[4:7])
        return blocks.count("table") in (1, 2) and all(
            blocks.count(s) < 2 for s in ("slider_right", "slider_left")
        )

    return [dict(zip(keys, vals)) for vals in product(*POSSIBLE_CONDITIONS.values()) if admissible(vals)]


def _chains_for_state(args) -> List[np.ndarray]:
    """Rejection-sample ``n`` valid chains for one initial state with the
    state-index-seeded legacy RNG (reference: multistep_sequences.py:334-344).
    The draw pattern (np.random.choice without replacement over TASK_NAMES)
    must not change — it defines the benchmark."""
    state, n, seed = args
    np.random.seed(seed)
    chains: List[np.ndarray] = []
    names = list(TASK_NAMES)
    while len(chains) < n:
        cand = np.random.choice(names, size=CHAIN_LEN, replace=False)
        if is_chain_valid(state, cand):
            chains.append(cand)
    return chains


def _sequences_fingerprint() -> str:
    """Cheap content hash over the benchmark-defining constants; guards the
    disk cache against code changes to the task set or chain rules."""
    import hashlib

    payload = repr((TASK_NAMES, CHAIN_LEN, sorted(POSSIBLE_CONDITIONS.items())))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _sequences_cache_path(n: int):
    import tempfile
    from pathlib import Path

    d = Path(os.environ.get("HULC2_SEQUENCES_CACHE_DIR", tempfile.gettempdir()))
    return d / f"hulc2_torch_sequences_{n}_{_sequences_fingerprint()}.json"


@functools.lru_cache
def get_sequences(num_sequences: int = 1000, num_workers: int = None) -> List[Tuple[Dict, Tuple[str, ...]]]:
    """The benchmark: ``num_sequences`` (initial_state, 5-task-chain) pairs.

    The chains are deterministic protocol constants (fixed seeds), so they
    are disk-cached per (count, constants-fingerprint): rejection sampling
    1000 chains costs ~2 min of pure Python on a 1-core host, paid once.
    Set HULC2_SEQUENCES_CACHE_DIR="" to disable.
    """
    import json

    cache = None
    if os.environ.get("HULC2_SEQUENCES_CACHE_DIR", "unset") != "":
        cache = _sequences_cache_path(num_sequences)
        if cache.is_file():
            try:
                data = json.loads(cache.read_text())
                return [(dict(state), tuple(chain)) for state, chain in data]
            except (ValueError, OSError):  # corrupt cache — recompute
                pass
    result = _compute_sequences(num_sequences, num_workers)
    if cache is not None:
        try:
            tmp = cache.with_suffix(f".tmp{os.getpid()}")
            tmp.write_text(json.dumps([[s, list(c)] for s, c in result]))
            tmp.replace(cache)  # atomic vs concurrent writers
        except OSError:
            pass
    return result


def _compute_sequences(num_sequences: int, num_workers=None) -> List[Tuple[Dict, Tuple[str, ...]]]:
    states = enumerate_initial_states()
    per_state = [len(part) for part in np.array_split(range(num_sequences), len(states))]

    with temp_seed(0):
        jobs = list(zip(states, per_state, range(len(states))))
        import os

        if (os.cpu_count() or 1) <= 1:
            chunks = _chains_sequential(jobs)
        else:
            # spawn (not fork): torch is usually initialized by now and fork()
            # of a multithreaded process can deadlock
            import multiprocessing as mp

            try:
                with ProcessPoolExecutor(
                    max_workers=num_workers, mp_context=mp.get_context("spawn")
                ) as pool:
                    chunks = list(pool.map(_chains_for_state, jobs))
            except Exception:  # constrained env (no fds / cgroup limits)
                chunks = _chains_sequential(jobs)
        flat = [tuple(chain.tolist()) for chunk in chunks for chain in chunk]
        results = list(zip(np.repeat(states, per_state), flat))
        np.random.shuffle(results)
    return results


def _chains_sequential(jobs) -> List[List[np.ndarray]]:
    """In-process fallback, bit-identical to the pooled path: the workers
    reseed the global legacy RNG per state, so save/restore the ambient
    temp_seed(0) state around them to keep the final shuffle unchanged."""
    saved = np.random.get_state()
    chunks = [_chains_for_state(a) for a in jobs]
    np.random.set_state(saved)
    return chunks


def exhaustive_sequences_for_state(state: Dict, num_sequences: int = None) -> List[Tuple[str, ...]]:
    """Every valid 5-chain from ``state``, breadth first, then a permutation
    seeded with ``temp_seed(0)`` that keeps chains of five distinct task
    categories and drops chains with the task set of an earlier one: the
    reference's exhaustive variant (multistep_sequences.py:292-321), in the
    JAX package's order."""
    frontier = [((), dict(state))]
    with temp_seed(0):
        for _ in range(CHAIN_LEN):
            nxt = []
            for chain, st in frontier:
                for name in TASK_NAMES:
                    for ns in successor_states(st, name):
                        nxt.append((chain + (name,), ns))
            frontier = nxt
        results, seen = [], []
        for idx in np.random.permutation(len(frontier)):
            chain = frontier[idx][0]
            cats = [TASK_CATEGORIES[n] for n in chain]
            if len(cats) == len(set(cats)) and set(chain) not in seen:
                results.append(chain)
                seen.append(set(chain))
    return results[:num_sequences] if num_sequences else results
