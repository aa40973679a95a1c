"""The run's metrics log (``hulc2_tpu/core/metrics.py``): one JSON line per
``log`` call in ``<run_dir>/metrics.jsonl``, with the step, the wall time and
the metrics under their prefix. The wandb and tensorboard sinks are not
ported."""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsLogger:
    def __init__(self, run_dir):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.run_dir / "metrics.jsonl", "a", buffering=1)

    def log(self, metrics: Dict, step: int, prefix: str = "") -> dict:
        rec = {"step": int(step), "time": time.time(),
               **{f"{prefix}{k}": float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self) -> None:
        self._fh.close()
