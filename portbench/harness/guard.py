"""What a run must not have: the JAX stack or the JAX package in its
process, and caches outside its checkout and its own directories."""
from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hulc2_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``hulc2_torch`` is not ``hulc2_tpu``)."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def pin_caches(root: Path) -> None:
    """Kernel and extension caches at fixed directories inside the checkout;
    libraries that would load JAX by themselves are told not to."""
    build = Path(root) / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
