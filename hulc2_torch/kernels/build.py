"""Build of the port's native sources, loaded with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point. It is compiled by
``nvcc`` for Hopper (``sm_90a``); the host library ``csrc/frameloader.cpp``
(the npz frame loader of the training path without the device store) by
``g++`` with zlib. Each goes into ``build/kernels/lib<name>-<hash>.so`` at
the repo root, where ``<hash>`` covers the source and its compiler's
flags, so an edited source is rebuilt and a stale library is never loaded.
Every source is compiled by its own compiler process, all started together.
A missing compiler or a failed build raises. Nothing is built at import
time: the first call of a wrapper builds what it needs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = {"shift_normalize": "shift_normalize.cu", "avg_pool2x2": "avg_pool2x2.cu",
           "frameloader": "frameloader.cpp"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-lz", "-lpthread")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native frame loader cannot be built")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS if SOURCES[name].endswith(".cu") else GXX_FLAGS + GXX_LIBS


def library_path(name: str) -> Path:
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> list:
    src = str(CSRC_DIR / SOURCES[name])
    if SOURCES[name].endswith(".cu"):
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), src]
    return [gxx_path(), *GXX_FLAGS, src, "-o", str(out), *GXX_LIBS]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, BuildResult]:
    """Compile the named sources (all by default) that have no up-to-date
    library, one compiler per source, in parallel. Raises on any failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = BuildResult(out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, Path(cmd[0]).name, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, compiler, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: {compiler} exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
        results[name] = BuildResult(out, time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("native build failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The shared library of source ``name``, built first if needed; safe to
    call from several threads (the frame loader runs in a thread pool)."""
    with _LOCK:
        if name not in _LOADED:
            path = build([name])[name].path
            _LOADED[name] = ctypes.CDLL(str(path))
        return _LOADED[name]
