"""Target assignment: the port of ``objectdetectionpl_tpu/ops/assignment.py``
(``build_targets_yolo``, ``build_targets_v5``, ``ssd_match``,
``retina_match``).

Padded per-image targets, as in the JAX package:

    labels: int   [B, M]      class ids (0-based)
    boxes:  float [B, M, 4]   (cx, cy, w, h) normalized to [0, 1]
    mask:   bool  [B, M]      True for real targets, False for padding

Every shape is fixed by (B, M, A): no host sync, no boolean indexing.
Padded targets scatter to a sentinel slot one past the end, which is then
cut off: they drop, never wrap.  The JAX functions match one image and are
vmapped; these take the batch as their leading dimension.  ``argmax``
resolves ties to the first index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from objectdetectionpl_tpu_torch.ops import boxes as box_ops


def _last_write_wins(lin_idx: torch.Tensor, valid: torch.Tensor,
                     size: int) -> torch.Tensor:
    """bool [N]: the valid entries that are the last valid occurrence of
    their index in ``lin_idx`` [N] (indices in [0, size)).

    The winner is the largest position per index, found by a
    ``scatter_reduce(amax)``, whose result does not depend on the order
    the device applies the writes in (a plain ``index_put_`` with
    duplicate indices has no defined order on CUDA).
    """
    n = lin_idx.shape[0]
    pos = torch.arange(n, device=lin_idx.device)
    key = torch.where(valid, lin_idx, size)
    last = torch.full((size + 1,), -1, dtype=pos.dtype, device=pos.device)
    last = last.scatter_reduce(0, key, pos, "amax")
    return valid & (last[key] == pos)


def _scatter(lin: torch.Tensor, vals, size: int) -> torch.Tensor:
    """float32 [size]: ``vals`` written at ``lin`` (index ``size`` drops).
    Callers pass indices that are unique or whose writes agree."""
    out = torch.zeros(size + 1, dtype=torch.float32, device=lin.device)
    return out.index_put_((lin,), torch.as_tensor(
        vals, dtype=torch.float32, device=lin.device).expand(lin.shape))[:size]


class YoloTargets(NamedTuple):
    """Dense per-cell targets for the YOLOv2/3/4 region losses (float32,
    ``noobj_mask`` bool; ``obj_mask`` is 0/1 floats, as in JAX)."""

    iou_scores: torch.Tensor   # [B, A, g, g]
    class_mask: torch.Tensor   # [B, A, g, g]
    obj_mask: torch.Tensor     # [B, A, g, g]
    noobj_mask: torch.Tensor   # [B, A, g, g] bool
    tx: torch.Tensor           # [B, A, g, g]
    ty: torch.Tensor
    tw: torch.Tensor
    th: torch.Tensor
    tcls: torch.Tensor         # [B, A, g, g, C]


def build_targets_yolo(pred_boxes: torch.Tensor, pred_cls: torch.Tensor,
                       labels: torch.Tensor, boxes: torch.Tensor,
                       mask: torch.Tensor, anchors: torch.Tensor,
                       ignore_thres: float = 0.5) -> YoloTargets:
    """YOLOv2/3/4 assignment: each target goes to its best anchor by wh-IoU
    at the cell that holds its center.

    pred_boxes [B, A, g, g, 4] decoded predictions in grid units (for the
    metrics only), pred_cls [B, A, g, g, C] class probabilities, anchors
    [A, 2] float32 grid units.  A cell hit by several targets keeps the
    last one's ``tx/ty/tw/th``, ``class_mask`` and ``iou_scores``; ``obj``
    and ``tcls`` take every write; ``noobj`` is cleared at assigned cells
    and at every anchor whose wh-IoU with a target there exceeds
    ``ignore_thres``.
    """
    B, A, g = pred_boxes.shape[0], pred_boxes.shape[1], pred_boxes.shape[2]
    C = pred_cls.shape[-1]
    M = labels.shape[1]
    dev = boxes.device

    tb = boxes * g                                   # grid units [B, M, 4]
    gxy, gwh = tb[..., :2], tb[..., 2:4]
    ious = box_ops.wh_iou(gwh[:, :, None, :], anchors[None, None])  # [B,M,A]
    best_n = ious.argmax(dim=-1)                     # first max, as jnp

    # truncation toward zero, as astype(int32)
    gi = gxy[..., 0].to(torch.int64).clamp(0, g - 1)
    gj = gxy[..., 1].to(torch.int64).clamp(0, g - 1)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, M)

    flat_mask = mask.reshape(-1)
    n_cells = B * A * g * g
    lin_cell = (((b_idx * A + best_n) * g + gj) * g + gi).reshape(-1)
    lin_cell = torch.where(flat_mask, lin_cell, n_cells)
    obj = _scatter(lin_cell, 1.0, n_cells).view(B, A, g, g)

    a_idx = torch.arange(A, device=dev)[None, None, :]
    lin_ign = (((b_idx[..., None] * A + a_idx) * g + gj[..., None]) * g
               + gi[..., None]).reshape(-1)
    ign_upd = (mask[..., None] & (ious > ignore_thres)).reshape(-1)
    lin_ign = torch.where(ign_upd, lin_ign, n_cells)
    cleared = _scatter(lin_ign, 1.0, n_cells).view(B, A, g, g)
    noobj = (obj == 0) & (cleared == 0)

    win = _last_write_wins(lin_cell, flat_mask, n_cells)
    lin_win = torch.where(win, lin_cell, n_cells)

    def scatter(vals):
        return _scatter(lin_win, vals.reshape(-1), n_cells).view(B, A, g, g)

    gx, gy = gxy[..., 0], gxy[..., 1]
    gw, gh = gwh[..., 0], gwh[..., 1]
    anc = anchors[best_n]                            # [B, M, 2]
    tx = scatter(gx - torch.floor(gx))
    ty = scatter(gy - torch.floor(gy))
    tw = scatter(torch.log(gw / anc[..., 0] + 1e-16))
    th = scatter(torch.log(gh / anc[..., 1] + 1e-16))

    # one-hot writes: a cell hit by two labels keeps both
    lbl = labels.clamp(0, C - 1).reshape(-1).to(torch.int64)
    lin_cls = torch.where(flat_mask, lin_cell * C + lbl, n_cells * C)
    tcls = _scatter(lin_cls, 1.0, n_cells * C).view(B, A, g, g, C)

    pb = pred_boxes[b_idx, best_n, gj, gi]           # [B, M, 4]
    pc = pred_cls[b_idx, best_n, gj, gi]             # [B, M, C]
    correct = (pc.argmax(dim=-1) == labels).to(torch.float32)
    iou_t = box_ops.iou_plus1(pb, tb, xyxy=False)
    return YoloTargets(scatter(iou_t), scatter(correct), obj, noobj,
                       tx, ty, tw, th, tcls)


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


class SSDMatch(NamedTuple):
    """SSD matching over D default boxes, per image of the batch."""

    matched: torch.Tensor       # [B, D] bool: positives
    best_ann: torch.Tensor      # [B, D] int64: index of the matched target
    true_offsets: torch.Tensor  # [B, D, 4] float32 encoded regression targets
    true_classes: torch.Tensor  # [B, D] int64: 0 background, 1..C classes


def ssd_match(default_xywh: torch.Tensor, labels: torch.Tensor,
              boxes: torch.Tensor, mask: torch.Tensor,
              match_thresh: float = 0.5) -> SSDMatch:
    """Bidirectional SSD matching.

    default_xywh [D, 4] center-form normalized; labels [B, M], boxes
    [B, M, 4] (normalized xywh), mask [B, M].  A default box matches the
    target of highest corner IoU when that IoU is >= ``match_thresh``; and
    every real target claims its best default box, the highest target
    index winning where two claim one box (a ``scatter_reduce(amax)``,
    whose result does not depend on the order of the writes).  Classes are
    1..C with 0 for background.
    """
    B, M = labels.shape
    D = default_xywh.shape[0]
    dev = boxes.device

    d_pts = box_ops.center_to_points_clipped(default_xywh)
    a_pts = box_ops.center_to_points_clipped(boxes)
    ious = box_ops.pairwise_iou_corner(a_pts, d_pts)            # [B, M, D]
    ious = torch.where(mask[:, :, None], ious, -1.0)

    ious_max = ious.amax(dim=1)                                 # [B, D]
    best_ann = ious.argmax(dim=1)          # first max, as jnp.argmax
    matched = ious_max >= match_thresh

    # forced matches: each real target claims its best default box; padded
    # rows aim at the sentinel column D, which is cut off
    forced = torch.where(mask, ious.argmax(dim=2), D)           # [B, M]
    ann_ids = torch.arange(M, device=dev).expand(B, M)
    claimed = torch.full((B, D + 1), -1, dtype=torch.int64, device=dev)
    claimed = claimed.scatter_reduce(1, forced, ann_ids, "amax")[:, :D]
    matched = matched | (claimed >= 0)
    best_ann = torch.maximum(best_ann, claimed)

    matched_boxes = torch.gather(boxes, 1,
                                 best_ann[..., None].expand(B, D, 4))
    # wh floored before the log-encode: a default box matched to a padded
    # (zero-size) target would give -inf offsets, and -inf * 0 = NaN
    matched_boxes = torch.cat([matched_boxes[..., :2],
                               matched_boxes[..., 2:4].clamp(min=1e-9)], -1)
    true_offsets = box_ops.ssd_encode(matched_boxes, default_xywh)
    true_classes = torch.where(
        matched, 1 + torch.gather(labels.long(), 1, best_ann), 0)
    return SSDMatch(matched, best_ann, true_offsets, true_classes)


class RetinaMatch(NamedTuple):
    loc_targets: torch.Tensor   # [B, A, 4] float32
    cls_targets: torch.Tensor   # [B, A] int64: -1 ignore, 0 bg, 1..C classes


def retina_match(anchors_xywh: torch.Tensor, labels: torch.Tensor,
                 boxes: torch.Tensor, mask: torch.Tensor,
                 img_size: float) -> RetinaMatch:
    """RetinaNet max-IoU matching.

    anchors_xywh [A, 4] center-form pixels; labels [B, M], boxes [B, M, 4]
    normalized xywh (scaled by ``img_size``), mask [B, M].  IoU with the +1
    convention: >= 0.5 the target's class, (0.4, 0.5) ignored (-1), the
    rest background (0), and an image without targets all background.
    """
    B = labels.shape[0]
    A = anchors_xywh.shape[0]
    boxes_px = boxes * img_size
    a_xyxy = box_ops.xywh_to_xyxy(anchors_xywh)
    b_xyxy = box_ops.xywh_to_xyxy(boxes_px)
    ious = box_ops.pairwise_iou_plus1(a_xyxy, b_xyxy)           # [B, A, M]
    ious = torch.where(mask[:, None, :], ious, -1.0)
    max_ious = ious.amax(dim=2)
    max_ids = ious.argmax(dim=2)           # first max, as jnp.argmax

    matched = torch.gather(boxes_px, 1, max_ids[..., None].expand(B, A, 4))
    # wh floor: see ssd_match
    matched = torch.cat([matched[..., :2], matched[..., 2:4].clamp(min=1e-6)],
                        -1)
    loc_targets = box_ops.retina_encode(matched, anchors_xywh)
    cls_targets = 1 + torch.gather(labels.long(), 1, max_ids)
    cls_targets = torch.where(max_ious < 0.5, 0, cls_targets)
    cls_targets = torch.where((max_ious > 0.4) & (max_ious < 0.5), -1,
                              cls_targets)
    cls_targets = torch.where(mask.any(dim=1, keepdim=True), cls_targets, 0)
    return RetinaMatch(loc_targets, cls_targets)
