"""The shift-and-normalize kernel's share of its roofline in the train
step: the bytes its launches must move per step (each camera's crops:
uint8 in once, the output once, the offsets; ``harness/counts``) over
3.35 TB/s, over the kernel's device time per step in the profiled slice,
found by ``PATTERN`` in the kernel names. Bound by bytes: its two fp32
operations per element take a hundredth of that time at the card's peak."""
import re

from portbench.harness.counts import H100_HBM_BYTES_PER_S, shift_normalize_bytes

PATTERN = re.compile(r"shift_normalize", re.IGNORECASE)


def read(rec):
    layers = rec.get("layers", {})
    prof = layers.get("profile")
    if not prof:
        return None
    seconds = sum(s for name, (s, _) in prof["by_name"].items() if PATTERN.search(name))
    if seconds <= 0:
        return None
    per_step = sum(shift_normalize_bytes(n, h, w, layers["crop_out_bytes"])
                   for n, h, w in layers["crops"])
    return 100.0 * per_step / H100_HBM_BYTES_PER_S / (seconds / prof["steps"])
