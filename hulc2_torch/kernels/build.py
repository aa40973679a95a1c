"""nvcc build of the port's CUDA sources, loaded with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled for
Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` at the repo
root, where ``<hash>`` covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Every source is compiled by its
own ``nvcc`` process, all started together. Nothing is built at import time:
the first call of a kernel wrapper builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = {"shift_normalize": "shift_normalize.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclass
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an up-to-date library was found
    log: str  # nvcc's output (ptxas register and spill report)


def nvcc_path() -> str:
    candidates = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in candidates:
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, BuildResult]:
    """Compile the named sources (all by default) that have no up-to-date
    library, one nvcc per source, in parallel. Raises on any failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    nvcc = nvcc_path() if any(not library_path(n).exists() for n in names) else None
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = BuildResult(out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
        results[name] = BuildResult(out, time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel ``name``, built first if needed."""
    if name not in _LOADED:
        path = build([name])[name].path
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
