"""serve_p95_ms: the 95th percentile of the traced run's batches, each
from its dispatch to its detections on the host.  A closed loop at its
capacity: the tail moves with the host's hiccups, so it has no bound."""


def read(ctx):
    return ctx["end_to_end"].get("serve_p95_ms")
