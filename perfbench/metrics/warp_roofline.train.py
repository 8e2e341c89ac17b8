"""warp_roofline.train: % of the warp bound (``counts/warp_bound.py``:
the slots read once and written once, the pixels' coordinates and
blends) over the device time of the ``affine_warp*`` kernels that the
profiled steps launched (the warp's launch counter says how many)."""

from perfbench.counts import warp_bound
from perfbench.harness import trace


def read(ctx):
    warps = ctx["counts"].get("warps")
    t = trace.kernel_s(ctx["trace"], "affine_warp",
                       ctx["counts"].get("warp_kernels", 0))
    if not warps or t <= 0:
        return None
    bound = sum(warp_bound.bound_s(w["K"], w["H"], w["W"], w["C"],
                                   w["inv_used"]) for w in warps)
    return 100.0 * bound / t
