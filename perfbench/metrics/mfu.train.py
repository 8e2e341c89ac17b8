"""mfu.train: % of the card's bf16 peak that the trained images' forward
and backward FLOPs (counted on the frozen reference, ``counts/flops.py``;
no recomputation, loss or optimizer) make at the traced run's
train_img_per_s."""

from perfbench.counts import peaks


def read(ctx):
    rate = ctx["end_to_end"].get("train_img_per_s")
    flops = ctx["counts"].get("flops_train")
    if not rate or not flops:
        return None
    return 100.0 * flops * rate / peaks.BF16_FLOPS
