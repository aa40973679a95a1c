"""FNV-1 32-bit hash, bit-identical to the ``pyhash.fnv1_32`` C++ hasher the
reference uses for deterministic validation window sizes
(reference: hulc2/datasets/base_dataset.py:13,26-28).

Pure Python — runs host-side in the data pipeline, never on device.

The port's copy of ``hulc2_tpu/ops/fnv.py``, unchanged but for its imports.
"""
from __future__ import annotations

_FNV1_32_INIT = 0x811C9DC5
_FNV1_32_PRIME = 0x01000193
_MASK32 = 0xFFFFFFFF


def fnv1_32(data: bytes) -> int:
    """FNV-1 (multiply, then xor) 32-bit hash of ``data``."""
    h = _FNV1_32_INIT
    for byte in data:
        h = (h * _FNV1_32_PRIME) & _MASK32
        h ^= byte
    return h


def get_validation_window_size(idx: int, min_window_size: int, max_window_size: int) -> int:
    """Deterministic per-index validation window length in
    [min_window_size, max_window_size], matching the reference's
    ``hasher(str(idx)) % window_range`` scheme (base_dataset.py:26-28)."""
    window_range = max_window_size - min_window_size + 1
    return min_window_size + fnv1_32(str(idx).encode()) % window_range
