"""mfu.serve: % of the card's bf16 peak that the served images' forward
FLOPs (counted on the frozen reference, ``counts/flops.py``) make at the
traced run's serve_img_per_s."""

from perfbench.counts import peaks


def read(ctx):
    rate = ctx["end_to_end"].get("serve_img_per_s")
    flops = ctx["counts"].get("flops_forward")
    if not rate or not flops:
        return None
    return 100.0 * flops * rate / peaks.BF16_FLOPS
