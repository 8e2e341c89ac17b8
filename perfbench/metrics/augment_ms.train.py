"""augment_ms.train: device ms a step of the kernels launched inside the
benchmark's call of ``augment_batch`` (flips, colour, the warp kernel and
its write-back), over the profiled span."""

from perfbench.harness import trace


def read(ctx):
    found = trace.range_device_s(ctx["trace"], "augment")
    if not found or not found[1] or not found[0]:
        return None
    return 1e3 * found[0] / found[1]
