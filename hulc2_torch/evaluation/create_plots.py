"""Result plots from the port's results.json files (``hulc2_tpu/evaluation/create_plots.py``).

    python -m hulc2_torch.evaluation.create_plots RUN/evaluation/results.json [...]
        [--labels A B ...] [--out-dir plots]

Writes ``chain_sr.png`` (the success rate of 1-5 instructions in a row at
each file's best step), ``avg_seq_len.png`` (avg_seq_len over the steps of
each file) and ``task_sr.png`` (the first file's per-task success rates at
its best step). The files are those ``evaluation/harness.print_and_save``
writes; its ``best`` entry is skipped. On the host only; matplotlib is
imported by the functions that draw.
"""
from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


def _load(results_file) -> Dict[str, Dict]:
    """The step -> results entries of a results.json."""
    data = json.loads(Path(results_file).read_text())
    return {k: v for k, v in data.items()
            if k != "best" and isinstance(v, dict) and "avg_seq_len" in v}


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _best(data: Dict[str, Dict]) -> str:
    return max(data, key=lambda k: data[k]["avg_seq_len"])


def plot_chain_sr(results_files: Sequence, labels: Sequence[str], out_path) -> None:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for f, label in zip(results_files, labels):
        data = _load(f)
        best = _best(data)
        srs = [data[best]["chain_sr"][str(i)] for i in range(1, 6)]
        ax.plot(range(1, 6), srs, marker="o", label=f"{label} (ep {best})")
    ax.set_xlabel("instructions in a row")
    ax.set_ylabel("success rate")
    ax.set_xticks(range(1, 6))
    ax.set_ylim(0, 1)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    logger.info("wrote %s", out_path)


def plot_avg_seq_len(results_files: Sequence, labels: Sequence[str], out_path) -> None:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for f, label in zip(results_files, labels):
        data = _load(f)
        epochs = sorted(data, key=lambda k: (len(k), k))
        ax.plot(epochs, [data[e]["avg_seq_len"] for e in epochs], marker="o", label=label)
    ax.set_xlabel("checkpoint")
    ax.set_ylabel("avg successful sequence length")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    logger.info("wrote %s", out_path)


def plot_task_sr(results_file, out_path, epoch: Optional[str] = None) -> None:
    plt = _pyplot()
    data = _load(results_file)
    epoch = epoch or _best(data)
    info = data[epoch]["task_info"]
    tasks = sorted(info, key=lambda t: info[t]["success"] / max(info[t]["total"], 1))
    srs = [info[t]["success"] / max(info[t]["total"], 1) for t in tasks]
    fig, ax = plt.subplots(figsize=(7, max(4, 0.22 * len(tasks))))
    ax.barh(tasks, srs)
    ax.set_xlabel("success rate")
    ax.set_xlim(0, 1)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    logger.info("wrote %s", out_path)


def main(argv: Optional[List[str]] = None) -> List[Path]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("results", nargs="+", help="results.json files")
    p.add_argument("--labels", nargs="*", default=None)
    p.add_argument("--out-dir", default="plots")
    args = p.parse_args(argv)
    labels = args.labels or [Path(f).parent.name for f in args.results]
    if len(labels) != len(args.results):
        p.error(f"{len(labels)} labels for {len(args.results)} results files")
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = [out / "chain_sr.png", out / "avg_seq_len.png", out / "task_sr.png"]
    plot_chain_sr(args.results, labels, paths[0])
    plot_avg_seq_len(args.results, labels, paths[1])
    plot_task_sr(args.results[0], paths[2])
    return paths


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
