"""train_step_p95_ms.card_bound: the 95th percentile of the traced run's
steps, each from its dispatch to the completion of its update, in the
training cells whose card sets the pace."""


def read(ctx):
    return ctx["end_to_end"].get("train_step_p95_ms")
