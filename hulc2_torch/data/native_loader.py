"""ctypes binding of the native npz frame loader (``csrc/frameloader.cpp``;
``hulc2_tpu/data/native_loader.py``).

``load_frames_into`` fills a contiguous buffer with one entry of each of a
list of per-frame ``.npz`` files: each file's entry is found by walking its
zip headers and read (or inflated) straight into its row, in C++ without the
GIL, in ``n_threads`` threads. The library is built with g++ by
``kernels/build.py`` on first use. Unlike the JAX package's binding, which
returns ``None`` when the build fails and lets the caller fall back to
``np.load``, a missing toolchain or a failed build raises here, and so does
every error the loader reports.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from hulc2_torch.kernels import build

ERRORS = {
    -1: "entry not found",
    -2: "truncated archive",
    -3: "streaming zip entries unsupported",
    -4: "inflate failed",
    -5: "unsupported compression method",
    -6: "bad npy magic",
    -7: "output buffer too small",
    -8: "zip64 extra field missing",
    -9: "entry size differs from the buffer's frame size",
    -10: "file read failed",
}

_BOUND = set()


def get_lib() -> ctypes.CDLL:
    """The loader's library, built and its entry points typed on first use."""
    lib = build.load("frameloader")
    if id(lib) not in _BOUND:
        lib.fl_load_frames.restype = ctypes.c_int
        lib.fl_load_frames.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.fl_probe_entry.restype = ctypes.c_int64
        lib.fl_probe_entry.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        _BOUND.add(id(lib))
    return lib


def load_frames_into(paths: Sequence[str], key: str, out: np.ndarray, n_threads: int = 8) -> None:
    """Fill ``out[i]`` with entry ``key`` of ``paths[i]``. ``out`` is C
    contiguous with one row per path, each row as many bytes as the entry's
    payload."""
    if not out.flags["C_CONTIGUOUS"] or out.shape[0] != len(paths):
        raise ValueError(f"out must be C contiguous with {len(paths)} rows, got {out.shape}")
    lib = get_lib()
    arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    rc = lib.fl_load_frames(arr, len(paths), key.encode(), out.ctypes.data_as(ctypes.c_void_p),
                            out[0].nbytes, int(n_threads))
    if rc != 0:
        raise RuntimeError(f"native frame load of {key!r} failed: {ERRORS.get(rc, rc)}")


def probe_entry_bytes(path: str, key: str) -> int:
    """The payload bytes of entry ``key`` of one ``.npz`` file."""
    size = get_lib().fl_probe_entry(str(path).encode(), key.encode())
    if size < 0:
        raise RuntimeError(f"probe of {key!r} in {path} failed: {ERRORS.get(int(size), size)}")
    return int(size)
