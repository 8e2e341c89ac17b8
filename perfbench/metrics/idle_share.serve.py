"""idle_share.serve: % of the traced span of batchs in which the card
runs nothing, from the trace alone (the union of the kernels, copies and
memsets that ran in the span).  The profiler's own host cost slows a
launch-bound batch while it traces, so on such a cell this reads higher
than the idle share of an untraced batch."""

from perfbench.harness import trace


def read(ctx):
    return trace.idle_share(ctx["trace"])
