"""loss_ms.train: device ms a step of the kernels launched inside the
``loss_fn`` the benchmark hands to ``make_train_step`` (assignment and the
loss's forward; its backward runs outside the range), over the profiled
span."""

from perfbench.harness import trace


def read(ctx):
    found = trace.range_device_s(ctx["trace"], "loss")
    if not found or not found[1] or not found[0]:
        return None
    return 1e3 * found[0] / found[1]
