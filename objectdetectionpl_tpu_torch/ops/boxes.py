"""Box geometry on tensors: the YOLO subset of ``objectdetectionpl_tpu/ops/boxes.py``.

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
