"""Box geometry on tensors: the port of ``objectdetectionpl_tpu/ops/boxes.py``.

Elementwise and broadcastable over leading dims, in the input's dtype, with
the same operation order as the JAX functions so f32 results agree bitwise
where the backends round alike.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-16


def xywh_to_xyxy(box: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the last axis."""
    cx, cy, w, h = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def xyxy_to_xywh(box: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h) on the last axis."""
    x1, y1, x2, y2 = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def xyxy_to_xywh_plus1(box: torch.Tensor) -> torch.Tensor:
    """RetinaNet's ``change_box_order('xyxy2xywh')``: wh = max - min + 1."""
    x1, y1, x2, y2 = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1 + 1,
                        y2 - y1 + 1], dim=-1)


def iou_plus1(box1: torch.Tensor, box2: torch.Tensor,
              xyxy: bool = True) -> torch.Tensor:
    """Elementwise IoU with the +1-pixel convention and 1e-16 union eps.

    ``xyxy=False`` means center-form input.
    """
    if not xyxy:
        box1 = xywh_to_xyxy(box1)
        box2 = xywh_to_xyxy(box2)
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = (x2 - x1 + 1).clamp(min=0) * (y2 - y1 + 1).clamp(min=0)
    area1 = ((box1[..., 2] - box1[..., 0] + 1)
             * (box1[..., 3] - box1[..., 1] + 1))
    area2 = ((box2[..., 2] - box2[..., 0] + 1)
             * (box2[..., 3] - box2[..., 1] + 1))
    return inter / (area1 + area2 - inter + EPS)


def iou_v5(box1: torch.Tensor, box2: torch.Tensor, xyxy: bool = True,
           giou: bool = False, diou: bool = False,
           ciou: bool = False) -> torch.Tensor:
    """Elementwise IoU with GIoU/DIoU/CIoU variants (no +1 convention).

    The CIoU aspect-ratio weight ``alpha`` is detached, as in JAX.
    """
    if not xyxy:
        box1 = xywh_to_xyxy(box1)
        box2 = xywh_to_xyxy(box2)
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)

    inter = ((torch.minimum(b1_x2, b2_x2)
              - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2)
                - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1
    union = (w1 * h1 + EPS) + w2 * h2 - inter
    iou = inter / union
    if not (giou or diou or ciou):
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if giou:
        c_area = cw * ch + EPS
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + EPS
    rho2 = (((b2_x1 + b2_x2) - (b1_x1 + b1_x2)) ** 2 / 4
            + ((b2_y1 + b2_y2) - (b1_y1 + b1_y2)) ** 2 / 4)
    if diou:
        return iou - rho2 / c2
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (1 - iou + v)).detach()
    return iou - (rho2 / c2 + v * alpha)


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU of (w, h) pairs that share their top-left corner, broadcast
    over the leading dims of ``wh1 [..., 2]`` and ``wh2 [..., 2]``."""
    inter = (torch.minimum(wh1[..., 0], wh2[..., 0])
             * torch.minimum(wh1[..., 1], wh2[..., 1]))
    union = (wh1[..., 0] * wh1[..., 1] + EPS) + wh2[..., 0] * wh2[..., 1] \
        - inter
    return inter / union


def grid_offsets(g: int, dtype: torch.dtype, device) -> torch.Tensor:
    """[g, g, (x, y)] integer cell offsets of a g x g map, in ``dtype``."""
    ar = torch.arange(g, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def iou_corner(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Elementwise corner-form IoU, no +1 pixel and no eps (SSD matching);
    negative widths and heights count as 0."""
    lt = torch.maximum(box1[..., :2], box2[..., :2])
    rb = torch.minimum(box1[..., 2:4], box2[..., 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    wh1 = (box1[..., 2:4] - box1[..., :2]).clamp(min=0.0)
    wh2 = (box2[..., 2:4] - box2[..., :2]).clamp(min=0.0)
    return inter / (wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1]
                    - inter)


def pairwise_iou_plus1(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """IoU with the +1 convention (RetinaNet anchor matching) between every
    pair of ``box1 [..., N, 4]`` and ``box2 [..., M, 4]`` (xyxy), shared
    leading dims: [..., N, M].  No union eps, as in JAX."""
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:4], box2[..., None, :, 2:4])
    wh = (rb - lt + 1).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = ((box1[..., 2] - box1[..., 0] + 1)
             * (box1[..., 3] - box1[..., 1] + 1))
    area2 = ((box2[..., 2] - box2[..., 0] + 1)
             * (box2[..., 3] - box2[..., 1] + 1))
    return inter / (area1[..., :, None] + area2[..., None, :] - inter)


def pairwise_iou_corner(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Corner-form IoU without +1 (SSD matching) between every pair of
    ``box1 [..., N, 4]`` and ``box2 [..., M, 4]``: [..., N, M]."""
    return iou_corner(box1[..., :, None, :], box2[..., None, :, :])


# --- SSD / RetinaNet box codecs --------------------------------------------

SSD_VARIANCE_XY = 0.1
SSD_VARIANCE_WH = 0.2


def ssd_encode(matched_xywh: torch.Tensor, default_xywh: torch.Tensor,
               use_variance: bool = True) -> torch.Tensor:
    """Offsets of matched center-form boxes against the default boxes:
    xy / (wh_d * 0.1), log(wh / wh_d) / 0.2 (without the variances when
    ``use_variance`` is False)."""
    off_cxy = matched_xywh[..., :2] - default_xywh[..., :2]
    if use_variance:
        off_cxy = off_cxy / (default_xywh[..., 2:4] * SSD_VARIANCE_XY)
    else:
        off_cxy = off_cxy / default_xywh[..., 2:4]
    off_wh = torch.log(matched_xywh[..., 2:4] / default_xywh[..., 2:4])
    if use_variance:
        off_wh = off_wh / SSD_VARIANCE_WH
    return torch.cat([off_cxy, off_wh], dim=-1)


def ssd_decode(offsets: torch.Tensor, default_xywh: torch.Tensor,
               use_variance: bool = True) -> torch.Tensor:
    """Invert :func:`ssd_encode` -> center-form boxes."""
    var_xy = SSD_VARIANCE_XY if use_variance else 1.0
    var_wh = SSD_VARIANCE_WH if use_variance else 1.0
    cxy = (offsets[..., :2] * var_xy * default_xywh[..., 2:4]
           + default_xywh[..., :2])
    wh = torch.exp(offsets[..., 2:4] * var_wh) * default_xywh[..., 2:4]
    return torch.cat([cxy, wh], dim=-1)


def retina_encode(matched_xywh: torch.Tensor,
                  anchor_xywh: torch.Tensor) -> torch.Tensor:
    """RetinaNet offsets: (xy - xy_a) / wh_a, log(wh / wh_a)."""
    loc_xy = ((matched_xywh[..., :2] - anchor_xywh[..., :2])
              / anchor_xywh[..., 2:4])
    loc_wh = torch.log(matched_xywh[..., 2:4] / anchor_xywh[..., 2:4])
    return torch.cat([loc_xy, loc_wh], dim=-1)


def retina_decode(offsets: torch.Tensor,
                  anchor_xywh: torch.Tensor) -> torch.Tensor:
    """Invert :func:`retina_encode` -> center-form boxes."""
    cxy = offsets[..., :2] * anchor_xywh[..., 2:4] + anchor_xywh[..., :2]
    wh = torch.exp(offsets[..., 2:4]) * anchor_xywh[..., 2:4]
    return torch.cat([cxy, wh], dim=-1)


def center_to_points_clipped(xywh: torch.Tensor) -> torch.Tensor:
    """Center-form -> corner-form, the corners clipped into [0, 1]."""
    lp = (xywh[..., :2] - xywh[..., 2:4] / 2.0).clamp(min=0.0)
    rp = (xywh[..., :2] + xywh[..., 2:4] / 2.0).clamp(max=1.0)
    return torch.cat([lp, rp], dim=-1)
