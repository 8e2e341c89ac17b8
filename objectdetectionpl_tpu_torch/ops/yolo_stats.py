"""Per-grid YOLO test statistics: the port of ``objectdetectionpl_tpu/ops/yolo_stats.py``.

cls_acc, recall50/75, precision, conf_obj and conf_noobj per output map of
YOLOv2/v3/v4, from the decoded map and ``build_targets_yolo`` over padded
targets; scalar tensors on the maps' device, no host sync.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from objectdetectionpl_tpu_torch.ops import assignment
from objectdetectionpl_tpu_torch.ops.losses import (decode_yolo_boxes,
                                                   decode_yolo_map)


def yolo_scale_statistics(x: torch.Tensor, labels: torch.Tensor,
                          boxes: torch.Tensor, mask: torch.Tensor,
                          anchors_grid: torch.Tensor, num_classes: int,
                          ignore_thres: float = 0.5
                          ) -> Dict[str, torch.Tensor]:
    """The six statistics of one raw map [B, A*(5+C), g, g]; anchors
    [A, 2] float32 grid units.  Unlike the loss, the box decode does not
    cap the exp of ``wh``."""
    xy, wh, conf, cls = decode_yolo_map(x, anchors_grid.shape[0],
                                        num_classes)
    pred_boxes = decode_yolo_boxes(xy, wh, anchors_grid, cap_wh=False)

    t = assignment.build_targets_yolo(pred_boxes, cls, labels, boxes, mask,
                                      anchors_grid, ignore_thres)
    obj = t.obj_mask
    noobj = t.noobj_mask.to(torch.float32)
    eps = 1e-16

    conf50 = (conf > 0.5).to(torch.float32)
    iou50 = (t.iou_scores > 0.5).to(torch.float32)
    iou75 = (t.iou_scores > 0.75).to(torch.float32)
    detected = conf50 * t.class_mask * obj
    n_obj = obj.sum()
    return {
        "cls_acc": 100.0 * (t.class_mask * obj).sum() / n_obj.clamp(min=1.0),
        "recall50": (iou50 * detected).sum() / (n_obj + eps),
        "recall75": (iou75 * detected).sum() / (n_obj + eps),
        "precision": (iou50 * detected).sum() / (conf50.sum() + eps),
        "conf_obj": (conf * obj).sum() / n_obj.clamp(min=1.0),
        "conf_noobj": (conf * noobj).sum() / noobj.sum().clamp(min=1.0),
    }


def yolo_statistics(outputs, labels, boxes, mask,
                    anchors_grid_per_scale: Sequence[torch.Tensor],
                    num_classes: int) -> Dict[int, Dict[str, torch.Tensor]]:
    """:func:`yolo_scale_statistics` per output map, keyed by grid size."""
    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    return {x.shape[2]: yolo_scale_statistics(x, labels, boxes, mask,
                                              torch.as_tensor(anc,
                                                              device=x.device),
                                              num_classes)
            for x, anc in zip(outputs, anchors_grid_per_scale)}
