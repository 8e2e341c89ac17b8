"""The least time of greedy NMS on a batch, the same count for every K
and whichever route the port takes for it.

Every input row is read once and its result written once (``ROW_BYTES``:
the box, score, label and weight in, the box and keep flag out); each
valid row's area and merge share is computed once; and each suppressed
valid row needs at least the one IoU test against its first kept
suppressor.  The bound is the larger of the operations at the float32
peak and the bytes at the HBM rate.
"""

from __future__ import annotations

from perfbench.counts import peaks

ROW_BYTES = 16 + 4 + 4 + 4 + 16 + 1
IOU_PAIR_OPS = 16        # the +1-pixel IoU of one pair and its compare
AREA_OPS = 5             # (x2 - x1 + 1) * (y2 - y1 + 1)
MERGE_ROW_OPS = 9        # w * box into the sums, and the division


def bound_s(rows: int, valid: int, suppressed: int) -> float:
    """Seconds for ``rows`` input rows of which ``valid`` are valid and
    ``suppressed`` of those are suppressed."""
    ops = suppressed * IOU_PAIR_OPS + valid * (AREA_OPS + MERGE_ROW_OPS)
    return max(ops / peaks.F32_FLOPS, rows * ROW_BYTES / peaks.HBM_BYTES_PER_S)
