"""Evaluate every checkpoint of a run (``hulc2_tpu/evaluation/run_multiple.py``).

    python -m hulc2_torch.evaluation.run_multiple --train-dir RUN \\
        [--checkpoints STEP ...] [--workers 1] --fake-env [evaluate_policy flags ...]

Each step of ``RUN/saved_models/<step>.pt`` (or each of ``--checkpoints``) is
scored by ``evaluate_policy --train-dir RUN --checkpoint STEP`` with every
other flag given here passed on as it is (``--device-render``,
``--paraphrase-eval``, ``--single-step``, ``--aff-train-dir``, ``--log-dir``,
``--device`` and the rest), so all steps write one ``results.json``, whose
"best" is the step with the highest avg_seq_len among all of them. With
``--workers 1`` (the default) the steps run one after another in this
process, on the one card; ``--workers N`` splits them over N processes.

The JAX original passes on only the flags its own parser lists, and
``evaluate_policy --all-checkpoints`` hands it two it rejects
(``--device-render``, ``--paraphrase-eval``) and drops ``--log-dir`` and
``--aff-checkpoint``; here the flags are not listed twice.
"""
from __future__ import annotations

import argparse
import logging
import subprocess
import sys
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

# evaluate_policy's flags that pick the policy: run_multiple sets them per step
_PER_STEP = ("--checkpoint", "--all-checkpoints", "--synthetic")


def list_checkpoints(train_dir) -> List[int]:
    from hulc2_torch.core.checkpoint import CheckpointManager

    return CheckpointManager(train_dir).all_steps()


def main(argv: Optional[Sequence[str]] = None):
    """The merged results of the last step with ``--workers 1``, else the
    workers' combined exit code."""
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train-dir", required=True)
    p.add_argument("--checkpoints", type=int, nargs="+", default=None,
                   help="the steps to evaluate (default: every saved step)")
    p.add_argument("--workers", type=int, default=1,
                   help="processes to split the steps over (default: 1, in this process)")
    args, rest = p.parse_known_args(argv)
    bad = [a for a in rest if a.split("=")[0] in _PER_STEP]
    if bad:
        p.error(f"{' '.join(bad)}: run_multiple picks the step of each evaluation")
    steps = args.checkpoints or list_checkpoints(args.train_dir)
    if not steps:
        p.error(f"--train-dir {args.train_dir}: no checkpoints under saved_models/")
    logger.info("evaluating %d checkpoints: %s", len(steps), steps)

    if args.workers <= 1:
        from hulc2_torch.evaluation import evaluate_policy

        merged = None
        for step in steps:
            merged = evaluate_policy.main(["--train-dir", args.train_dir,
                                           "--checkpoint", str(step), *rest])
        return merged

    procs = []
    for shard in np.array_split(np.asarray(steps), args.workers):
        if len(shard):
            procs.append(subprocess.Popen([
                sys.executable, "-m", "hulc2_torch.evaluation.run_multiple",
                "--train-dir", args.train_dir, "--checkpoints", *map(str, shard), *rest]))
    rc = 0
    for proc in procs:
        rc |= proc.wait()
    return rc


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    out = main(sys.argv[1:])
    sys.exit(out if isinstance(out, int) else 0)
