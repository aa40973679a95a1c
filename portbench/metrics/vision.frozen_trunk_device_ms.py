"""Device ms a step under the program's span ``vision.frozen_trunk``: a
pretrained encoder's trunk run without a graph (``freeze_backbone``), in
the program slice's eager steps: the union of the device activities that
the span's host interval launched (``harness/program_trace``)."""
from portbench.harness.program_trace import span_row


def read(rec):
    row = span_row(rec, "eager", "vision.frozen_trunk")
    return None if row is None or "device_ms" not in row else row["device_ms"]
