"""The train step's share of the card's bf16 peak: the reference step's
FLOPs (``harness/counts.count_flops`` at the cell's batch shapes) times the
window's steps over the window's seconds on the host clock, over 989
TFLOP/s."""
from portbench.harness.counts import H100_BF16_FLOPS


def read(rec):
    layers = rec.get("layers", {})
    flops = layers.get("flops_per_step")
    if not flops or not layers.get("steps"):
        return None
    return flops * layers["steps"] / layers["window_s"] / H100_BF16_FLOPS
