"""The frozen trunk's share of the card's bf16 peak: the reference trunk's
FLOPs a frame (``harness/frozen_trunk``: the plain tower at the camera's
side after the transform, counted on the meta device) times the program's
counter ``vision.frozen_trunk_frames`` a step, over the device ms a step
under its span ``vision.frozen_trunk``, both from the program slice's eager
steps, over 989 TFLOP/s."""
from portbench.harness.counts import H100_BF16_FLOPS
from portbench.harness.program_trace import span_row

METRIC = "vision.frozen_trunk_mfu"


def read(rec):
    row = span_row(rec, "eager", "vision.frozen_trunk")
    program = rec.get("layers", {}).get("program") or {}
    frames = ((program.get("eager") or {}).get("counters") or {}).get("vision.frozen_trunk_frames")
    if row is None or not row.get("device_ms") or not frames:
        return None
    from portbench.harness.frozen_trunk import flops_per_frame

    flops = flops_per_frame(METRIC)
    if flops is None:
        return None
    return flops * frames / (row["device_ms"] / 1e3) / H100_BF16_FLOPS
