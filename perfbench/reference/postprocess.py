"""YOLOv5's serving tail in plain PyTorch: the decode of the three head
maps, the top-k candidates and the class-aware greedy NMS with the
objectness-weighted merge (+1-pixel IoU).  The frozen reference of the
port's ``ops/nms.py`` (``decode_yolov5_predictions``, ``yolo_candidates``,
``yolo_nms``) and of ``ops/cuda/nms_kernel.py::greedy_nms_plain``.

The decode and the ranking run in the maps' own dtype, as the
configuration states its compute; the suppression scan in float32.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def decode(outputs, anchors, strides, num_classes: int) -> torch.Tensor:
    """[B, 3, g, g, 5+C] maps -> [B, N, 5+C] rows: xy = (2 sigmoid - 0.5 +
    cell) * stride, wh = (2 sigmoid)^2 * anchor, obj and classes sigmoid."""
    parts = []
    for x, anc_px, stride in zip(outputs, anchors, strides):
        B, A, g, _, _ = x.shape
        ar = torch.arange(g, dtype=x.dtype, device=x.device)
        gy, gx = torch.meshgrid(ar, ar, indexing="ij")
        grid = torch.stack([gx, gy], -1)
        anc = torch.as_tensor(anc_px, dtype=x.dtype,
                              device=x.device).reshape(1, A, 1, 1, 2)
        sig = torch.sigmoid(x)
        xy = (sig[..., :2] * 2.0 - 0.5 + grid) * stride
        wh = (sig[..., 2:4] * 2.0) ** 2 * anc
        parts.append(torch.cat([xy, wh, sig[..., 4:]], -1)
                     .reshape(B, -1, 5 + num_classes))
    return torch.cat(parts, 1)


def candidates(pred, conf_thres: float, top_k: int):
    """(boxes xyxy, scores, labels, obj, cls) of the top_k rows by obj *
    max class among obj >= conf_thres, ties to the lower index."""
    top_k = min(top_k, pred.shape[1])
    cx, cy, w, h = pred[..., :4].unbind(-1)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    obj = pred[..., 4]
    cls = pred[..., 5:].amax(-1)
    label = pred[..., 5:].argmax(-1).to(torch.int32)
    score = torch.where(obj >= conf_thres, obj * cls, NEG_INF)
    values, idx = torch.sort(score, dim=-1, descending=True,
                              stable=True)
    values, idx = values[..., :top_k], idx[..., :top_k]
    take = lambda t: torch.gather(t, 1, idx)
    return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), values,
            take(label), take(obj), take(cls))


def greedy_nms(boxes, scores, labels, weight, thresh: float):
    """Class-aware greedy NMS over rows sorted by score, in float32: a kept
    box becomes the weight-averaged mean of itself and the rows it is the
    first kept row to suppress.  Returns (boxes [B, K, 4], keep [B, K])."""
    B, K, _ = boxes.shape
    dev = boxes.device
    valid = scores > NEG_INF
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :]) + 1.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :]) + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-16)
    over = ((iou > thresh) & (labels[:, :, None] == labels[:, None, :])
            & torch.ones(K, K, dtype=torch.bool, device=dev).triu(1)
            & valid[:, :, None] & valid[:, None, :])
    keep = torch.zeros(B, K, dtype=torch.bool, device=dev)
    suppressed = torch.zeros_like(keep)
    for i in range(K):
        kept = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = kept
        suppressed |= kept[:, None] & over[:, i]
    ids = torch.arange(K, device=dev)
    first = torch.where(keep[:, :, None] & over, ids[:, None], K).amin(1)
    w = torch.where(valid, weight, 0.0)
    num = torch.zeros(B, K + 1, 4, device=dev).scatter_add_(
        1, first[..., None].expand(B, K, 4), w[..., None] * boxes)
    den = torch.zeros(B, K + 1, device=dev).scatter_add_(1, first, w)
    merged = ((num[:, :K] + w[..., None] * boxes)
              / (den[:, :K] + w).clamp(min=1e-16)[..., None])
    return torch.where(keep[..., None], merged, boxes), keep


def yolo_nms(outputs, cfg: dict, traffic: dict):
    """The whole tail on the maps: (boxes, obj, scores, labels, valid) as
    the port's ``NMSResult`` orders them."""
    m = cfg["model"]
    pred = decode(outputs, m["anchors"], m["strides"], m["num_classes"])
    boxes, scores, labels, obj, cls = candidates(pred, traffic["conf_thres"],
                                                 traffic["top_k"])
    weight = torch.where(scores > NEG_INF, obj, 0.0)
    kept, keep = greedy_nms(boxes.float(), scores.float(), labels,
                            weight.float(), traffic["nms_thres"])
    v = keep & (scores > NEG_INF)
    return (kept, torch.where(v, obj, 0.0), torch.where(v, cls, 0.0), labels,
            v)
