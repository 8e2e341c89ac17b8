"""dispatch_ms.train: host ms a step spends dispatching /255, the
augmentation and ``train_step`` (no sync), the mean over the traced run's
window steps outside the profiled span."""


def read(ctx):
    if "train_img_per_s" not in ctx["end_to_end"]:
        return None
    skip = set(ctx["out"]["profiled"])
    calls = [s for j, s in ctx["out"]["call_s"] if j not in skip]
    return 1e3 * sum(calls) / len(calls) if calls else None
