"""postprocess_ms.serve: device ms a batch of the kernels launched inside
the postprocess the benchmark hands to ``make_predict_step`` (decode,
top-k, NMS), over the profiled span."""

from perfbench.harness import trace


def read(ctx):
    found = trace.range_device_s(ctx["trace"], "postprocess")
    if not found or not found[1] or not found[0]:
        return None
    return 1e3 * found[0] / found[1]
