"""YOLOv5 target assignment: the port of ``build_targets_v5`` in ``objectdetectionpl_tpu/ops/assignment.py``.

Padded per-image targets, as in the JAX package:

    labels: int   [B, M]      class ids (0-based)
    boxes:  float [B, M, 4]   (cx, cy, w, h) normalized to [0, 1]
    mask:   bool  [B, M]      True for real targets, False for padding

Every shape is fixed by (B, M, A): no host sync, no boolean indexing.
The other families' assignment comes with their slices (ROADMAP A9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V5Targets(NamedTuple):
    """Fixed-size YOLOv5 assignment for one detection layer.

    K = M * A * 3 candidate slots per image (center + one x-neighbor + one
    y-neighbor: of the reference's five rect4 offsets at most three can be
    active per box).  Flattened over (B, M, A, 3).
    """

    b: torch.Tensor      # [B*K] image index
    a: torch.Tensor      # [B*K] anchor index
    gj: torch.Tensor     # [B*K] grid row, clipped to [0, g-1]
    gi: torch.Tensor     # [B*K] grid col, clipped to [0, g-1]
    tbox: torch.Tensor   # [B*K, 4] (dx, dy, w, h) in grid units
    anch: torch.Tensor   # [B*K, 2] anchor wh in grid units
    tcls: torch.Tensor   # [B*K] class id
    valid: torch.Tensor  # [B*K] bool


def build_targets_v5(labels: torch.Tensor, boxes: torch.Tensor,
                     mask: torch.Tensor, anchors_layer: torch.Tensor,
                     grid_size: int, anchor_t: float = 4.0) -> V5Targets:
    """Vectorized YOLOv5 'rect4' assignment for one layer.

    ``anchors_layer`` [A, 2] in *grid* units for this layer, on the targets'
    device.  Indices of invalid slots are clipped into the grid so gathers
    stay in bounds; ``valid`` masks them.
    """
    B, M = labels.shape
    A = anchors_layer.shape[0]
    gsz = float(grid_size)
    dev = boxes.device

    t = boxes * gsz                                  # [B, M, 4] grid units
    gxy, gwh = t[..., :2], t[..., 2:4]

    # wh-ratio filter: max(r, 1/r).max(-1) < anchor_t  -> [B, M, A]
    r = gwh[:, :, None, :] / anchors_layer[None, None, :, :]
    ratio_ok = torch.maximum(r, 1.0 / r).amax(dim=-1) < anchor_t
    base = mask[:, :, None] & ratio_ok

    # frac < 0.5 selects the lo neighbor (offset +1), frac > 0.5 the hi one
    # (-1), never both; torch's float % is floor-mod, as jnp's.
    frac = gxy % 1.0
    lo = frac < 0.5                                  # [B, M, 2] (x, y)
    sgn = torch.where(lo, 1.0, -1.0)
    in_rng = torch.where(lo, gxy > 1.0, gxy < gsz - 1.0)
    variant_ok = torch.stack([torch.ones_like(in_rng[..., 0]),
                              in_rng[..., 0], in_rng[..., 1]], dim=-1)

    zero = torch.zeros_like(sgn[..., 0])
    offs = torch.stack([torch.stack([zero, zero], -1),          # center
                        torch.stack([sgn[..., 0], zero], -1),   # x neighbor
                        torch.stack([zero, sgn[..., 1]], -1)],  # y neighbor
                       dim=2) * 0.5                  # [B, M, 3, 2]

    valid = base[:, :, :, None] & variant_ok[:, :, None, :]    # [B, M, A, 3]
    gij = torch.floor(gxy[:, :, None, :] - offs)     # [B, M, 3, 2]
    shape = (B, M, A, 3)
    gi = gij[..., 0].to(torch.int64)[:, :, None, :].expand(shape)
    gj = gij[..., 1].to(torch.int64)[:, :, None, :].expand(shape)

    dxy = gxy[:, :, None, :] - gij                   # [B, M, 3, 2]
    tbox = torch.cat([dxy[:, :, None].expand(B, M, A, 3, 2),
                      gwh[:, :, None, None, :].expand(B, M, A, 3, 2)], dim=-1)

    b_idx = torch.arange(B, device=dev)[:, None, None, None].expand(shape)
    a_idx = torch.arange(A, device=dev)[None, None, :, None].expand(shape)
    anch = anchors_layer[None, None, :, None, :].expand(B, M, A, 3, 2)
    cls = labels[:, :, None, None].expand(shape)

    n = B * M * A * 3
    return V5Targets(
        b_idx.reshape(n), a_idx.reshape(n),
        gj.reshape(n).clamp(0, grid_size - 1),
        gi.reshape(n).clamp(0, grid_size - 1),
        tbox.reshape(n, 4), anch.reshape(n, 2), cls.reshape(n),
        valid.reshape(n))
