"""nms_roofline.serve: % of the NMS bound (``counts/nms_bound.py``, one
count for every K) over the device time of the ``greedy_nms*`` kernels
the profiled batches launched (the NMS op's launch counters say how
many)."""

from perfbench.counts import nms_bound
from perfbench.harness import trace


def read(ctx):
    batches = ctx["counts"].get("nms_batches")
    t = trace.kernel_s(ctx["trace"], "greedy_nms",
                       ctx["counts"].get("nms_kernels", 0))
    if not batches or t <= 0:
        return None
    bound = sum(nms_bound.bound_s(b["rows"], b["valid"], b["suppressed"])
                for b in batches)
    return 100.0 * bound / t
