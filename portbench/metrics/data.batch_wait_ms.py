"""Mean host wait per step for the next batch from the prefetcher, over the
window's steps: the benchmark's span around each ``next()``."""


def read(rec):
    waits = rec.get("layers", {}).get("batch_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
