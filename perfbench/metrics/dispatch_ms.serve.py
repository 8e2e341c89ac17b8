"""dispatch_ms.serve: host ms a batch spends in the call of
``predict_step`` (model, decode, NMS launched; no sync), the mean over the
traced run's window batches outside the profiled span."""


def read(ctx):
    if "serve_img_per_s" not in ctx["end_to_end"]:
        return None
    skip = set(ctx["out"]["profiled"])
    calls = [s for i, s in ctx["out"]["call_s"] if i >= 0 and i not in skip]
    return 1e3 * sum(calls) / len(calls) if calls else None
