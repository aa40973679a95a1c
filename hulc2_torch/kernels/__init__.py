"""Hand-written CUDA kernels of the port: build, loading and launch counts.

``LAUNCHES`` maps each kernel name to the number of times its wrapper has
launched it on the card. A wrapper adds one right after a successful launch
and nowhere else; its plain PyTorch version (taken for CPU tensors) does not
count. A launch recorded into a CUDA graph counts there once, at the
capture. ``REPLAYED`` counts apart the launches that later replays of such
a graph ran again: a replayed train step (``train/steps.StepGraphs``) adds
the launches its capture recorded; ``tools/profile_train`` finds the
replayed kernels on the device trace. ``launch_counts`` sums the two.
``chip_smoke.py`` resets the counts before it drives the main path and
reads them after, to show that the path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"shift_normalize": 0, "avg_pool2x2": 0}
REPLAYED: Dict[str, int] = {name: 0 for name in LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, REPLAYED):
        for name in counts:
            counts[name] = 0


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches on the card: its wrapper's and the replayed
    graphs'."""
    return {name: n + REPLAYED[name] for name, n in LAUNCHES.items()}
