"""Device busy per train step: the union of the device activities'
intervals in the profiled slice after the window, per step."""


def read(rec):
    prof = rec.get("layers", {}).get("profile")
    return None if not prof else 1e3 * prof["busy_s"] / prof["steps"]
