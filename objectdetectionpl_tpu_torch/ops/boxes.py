"""Box geometry on tensors: the serving subset of ``objectdetectionpl_tpu/ops/boxes.py``.

Elementwise and broadcastable over leading dims, in the input's dtype, with
the same operation order as the JAX functions so f32 results agree bitwise
where the backends round alike.
"""

from __future__ import annotations

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
