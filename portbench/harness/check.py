"""The comparisons that decide ``correct``: each a number beside its limit."""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between two norms of it: |prog - ref| over the larger
    of the reference's norm of that leaf and its median leaf's norm (a leaf
    missing from ``prog`` reads NaN)."""
    keys = sorted(ref if keys is None else keys)
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], median) for k in keys}


def moved_leaves(ref_grad: Dict[str, float], share: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's."""
    median = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items() if v >= share * median)


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every value finite and within its limit, {name: {value, limit}})."""
    missing = sorted(set(limits) - set(values))
    if missing:
        raise KeyError(f"no reading of {missing}")
    out = {k: {"value": float(values[k]), "limit": float(limits[k])} for k in sorted(limits)}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out
