"""Device ms a step under the program's span ``model.encode.rgb_static``:
the static camera's encoder (a pretrained tower with its head), inside
``model.encode``, in the program slice's eager steps: the union of the
device activities that the span's host interval launched
(``harness/program_trace``)."""
from portbench.harness.program_trace import span_row


def read(rec):
    row = span_row(rec, "eager", "model.encode.rgb_static")
    return None if row is None or "device_ms" not in row else row["device_ms"]
