"""Host ms of the prefetch thread's work a batch: its span
``prefetch.produce`` (the store's ``store.plan_rows`` and ``store.gather``,
``prefetch.to_device``) less ``prefetch.put`` inside it (blocked on a full
queue, the consumer's pace), over the batches produced in the program
slice's replayed steps (``harness/program_trace``)."""
from portbench.harness.program_trace import span_row


def read(rec):
    produce = span_row(rec, "replayed", "prefetch.produce")
    if produce is None or not produce["calls"]:
        return None
    put = span_row(rec, "replayed", "prefetch.put") or {"host_ms": 0.0}
    return (produce["host_ms"] - put["host_ms"]) / produce["calls"]
