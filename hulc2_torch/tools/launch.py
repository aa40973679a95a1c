"""Cluster launch and fault tolerance: sbatch scripts that resubmit on
timeout, and a watchdog that restarts a crashed run.

    python -m hulc2_torch.tools.launch sbatch --run-dir RUN [--gpus N] [--partition gpu]
        [--hours 24] [--command CMD] [override ...]
    python -m hulc2_torch.tools.launch watchdog CMD [ARG ...]

The port's copy of ``hulc2_tpu/tools/launch.py`` (reference:
slurm_scripts/slurm_training.py:26-140, slurm_scripts/sbatch_lfp.sh:12-27,
hulc2/wrap_training.py:109-143), for GPU nodes:

- ``generate_sbatch`` writes an sbatch script on a GPU partition with
  ``--gres=gpu:N`` that runs the trainer under ``timeout`` and resubmits
  itself on exit code 124 (the slurm-timeout contract), and a
  ``resume_training.sh``. The command defaults to ``python -m
  hulc2_torch.training``, and with N > 1 to ``torchrun --nproc_per_node N -m
  hulc2_torch.training`` (one data-parallel rank per card); a training
  command gets ``--run-dir``, any other command takes its paths through the
  overrides.
- ``watchdog`` runs a command and restarts it when it crashes, backing off
  when the last line of its stderr repeats. The trainer's checkpoint on
  SIGTERM and its auto-resume make a restart lose nothing.
"""
from __future__ import annotations

import argparse
import logging
import subprocess
import sys
import time
from collections import deque
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger(__name__)

SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --partition={partition}
#SBATCH --time={hours}:00:00
#SBATCH --cpus-per-task={cpus}
#SBATCH --gres=gpu:{gpus}
#SBATCH --output={run_dir}/slurm-%j.out
{extra_directives}

# run under timeout; on timeout (124) requeue this same script
timeout {timeout_hours}h {command}{run_dir_flag} {overrides}
if [ $? -eq 124 ]; then
    echo "job timed out - resubmitting"
    sbatch $0
fi
"""

TRAINING = "hulc2_torch.training"


def generate_sbatch(
    run_dir,
    command: Optional[str] = None,
    overrides: Optional[List[str]] = None,
    job_name: str = "hulc2_torch",
    partition: str = "gpu",
    hours: int = 24,
    cpus: int = 8,
    gpus: int = 1,
    extra_directives: str = "",
) -> Path:
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    if command is None:
        command = (f"torchrun --nproc_per_node {gpus} -m {TRAINING}" if gpus > 1
                   else f"python -m {TRAINING}")
    words = command.split()
    is_training = TRAINING in words and words[words.index(TRAINING) - 1] == "-m"
    run_dir_flag = f" --run-dir {run_dir}" if is_training else ""
    script = SBATCH_TEMPLATE.format(
        job_name=job_name,
        partition=partition,
        hours=hours,
        timeout_hours=round(hours - 0.2, 1),
        cpus=cpus,
        gpus=gpus,
        run_dir=run_dir,
        command=command,
        run_dir_flag=run_dir_flag,
        overrides=" ".join(overrides or []),
        extra_directives=extra_directives,
    )
    sbatch_path = run_dir / "sbatch.sh"
    sbatch_path.write_text(script)
    resume = run_dir / "resume_training.sh"
    resume.write_text(f"#!/bin/bash\nsbatch {sbatch_path}\n")
    for p in (sbatch_path, resume):
        p.chmod(0o755)
    logger.info("wrote %s", sbatch_path)
    return sbatch_path


def watchdog(
    cmd: List[str],
    max_restarts: int = 20,
    same_error_limit: int = 3,
    backoff_s: float = 30.0,
) -> int:
    """Run ``cmd`` and restart it on a crash; when the last line of stderr is
    the same ``same_error_limit`` times in a row, wait ``backoff_s`` before
    the next try (reference: wrap_training.py:109-143)."""
    recent_errors: deque = deque(maxlen=same_error_limit)
    for attempt in range(max_restarts + 1):
        logger.info("watchdog: starting attempt %d: %s", attempt, " ".join(cmd))
        proc = subprocess.run(cmd, stderr=subprocess.PIPE, text=True)
        if proc.returncode == 0:
            logger.info("watchdog: clean exit")
            return 0
        tail = (proc.stderr or "").strip().splitlines()[-1:] or ["<no stderr>"]
        logger.error("watchdog: crashed (rc=%d): %s", proc.returncode, tail[0])
        recent_errors.append(tail[0])
        if len(recent_errors) == same_error_limit and len(set(recent_errors)) == 1:
            logger.error("watchdog: same error %d times — backing off %.0fs", same_error_limit, backoff_s)
            time.sleep(backoff_s)
            recent_errors.clear()
    logger.error("watchdog: giving up after %d restarts", max_restarts)
    return 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("sbatch")
    g.add_argument("--run-dir", required=True)
    g.add_argument("--job-name", default="hulc2_torch")
    g.add_argument("--partition", default="gpu")
    g.add_argument("--hours", type=int, default=24)
    g.add_argument("--gpus", type=int, default=1, help="cards of the node (torchrun above 1)")
    g.add_argument("--command", default=None,
                   help="entry to wrap (default: the trainer; e.g. the eval CLI)")
    g.add_argument("overrides", nargs="*")
    w = sub.add_parser("watchdog")
    w.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.cmd == "sbatch":
        generate_sbatch(args.run_dir, command=args.command, overrides=args.overrides,
                        job_name=args.job_name, partition=args.partition, hours=args.hours,
                        gpus=args.gpus)
        return 0
    return watchdog(args.command)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
