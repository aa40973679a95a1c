"""The device's idle share of the profiled train slice: 100 (1 - busy / wall)."""


def read(rec):
    prof = rec.get("layers", {}).get("profile")
    if not prof or "steps" not in rec.get("layers", {}):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
