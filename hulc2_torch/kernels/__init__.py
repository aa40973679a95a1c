"""Hand-written CUDA kernels of the port: build, loading and launch counts.

``LAUNCHES`` maps each kernel name to the number of times its wrapper has
launched it on the card. A wrapper adds one right after a successful launch
and nowhere else; its plain PyTorch version (taken for CPU tensors) does not
count. ``chip_smoke.py`` resets the counts before it drives the main path and
reads them after, to show that the path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"shift_normalize": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
