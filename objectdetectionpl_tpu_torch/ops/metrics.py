"""mAP / detection metrics: the port's copy of ``objectdetectionpl_tpu/ops/metrics.py``.

numpy on the host, as in the JAX package: greedy TP matching at IoU >= 0.5
(``batch_statistics``) -> ``ap_per_class`` -> ``compute_ap``
(precision-envelope AP) -> ``evaluate_map``.  The Trainer pulls each test
batch's detections to the host once and calls these.
"""

from __future__ import annotations

import numpy as np


def _iou_plus1_np(box, boxes):
    """+1-pixel-convention IoU of one box [4] against boxes [N, 4] (xyxy).

    Mirrors ``bbox_iou`` (accuracy.py:39-69).
    """
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    area1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    area2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (area1 + area2 - inter + 1e-16)


def batch_statistics(pred_boxes, pred_scores, pred_labels, pred_valid,
                     gt_boxes, gt_labels, gt_valid, iou_threshold: float = 0.5):
    """Greedy per-image TP matching; returns (tp, conf, pred_cls) arrays.

    Inputs are the fixed-shape NMS outputs ([B, K, ...]) and padded GT
    ([B, M, ...], boxes xyxy in the same scale as predictions).  Semantics
    mirror ``get_batch_statistics`` (accuracy.py:116-154): predictions are
    scanned in their given (score-sorted) order; a prediction whose label is
    absent from the image's GT labels is skipped entirely; the best-IoU GT is
    claimed if IoU >= threshold and not already claimed; matching stops once
    every GT is claimed.
    """
    tps, confs, classes = [], [], []
    B = pred_boxes.shape[0]
    for i in range(B):
        pv = np.asarray(pred_valid[i], bool)
        if not pv.any():
            continue
        pb = np.asarray(pred_boxes[i])[pv]
        ps = np.asarray(pred_scores[i])[pv]
        pl = np.asarray(pred_labels[i])[pv]
        tp = np.zeros(len(pb))

        gv = np.asarray(gt_valid[i], bool)
        gb = np.asarray(gt_boxes[i])[gv]
        gl = np.asarray(gt_labels[i])[gv]
        if len(gb):
            detected = []
            for pi in range(len(pb)):
                if len(detected) == len(gb):
                    break
                if pl[pi] not in gl:
                    continue
                ious = _iou_plus1_np(pb[pi], gb)
                bi = int(np.argmax(ious))
                if ious[bi] >= iou_threshold and bi not in detected:
                    tp[pi] = 1
                    detected.append(bi)
        tps.append(tp)
        confs.append(ps)
        classes.append(pl)
    if not tps:
        return (np.zeros(0), np.zeros(0), np.zeros(0))
    return (np.concatenate(tps), np.concatenate(confs), np.concatenate(classes))


def compute_ap(recall, precision):
    """Precision-envelope AP (py-faster-rcnn style).

    Reference: accuracy.py:262-287.
    """
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])


def ap_per_class(tp, conf, pred_cls, target_cls):
    """Per-class precision/recall/AP/F1 from accumulated statistics.

    Reference: accuracy.py:207-260.  Returns (p, r, ap, f1, unique_classes).
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)

    ap, p, r = [], [], []
    for c in unique_classes:
        sel = pred_cls == c
        n_gt = (target_cls == c).sum()
        n_p = sel.sum()
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            ap.append(0.0)
            r.append(0.0)
            p.append(0.0)
        else:
            fpc = (1 - tp[sel]).cumsum()
            tpc = tp[sel].cumsum()
            recall_curve = tpc / (n_gt + 1e-16)
            r.append(recall_curve[-1])
            precision_curve = tpc / (tpc + fpc)
            p.append(precision_curve[-1])
            ap.append(compute_ap(recall_curve, precision_curve))

    p, r, ap = np.array(p), np.array(r), np.array(ap)
    f1 = 2 * p * r / (p + r + 1e-16)
    return p, r, ap, f1, unique_classes.astype("int32")


def evaluate_map(sample_stats, all_target_classes):
    """Aggregate per-batch statistics into the final metrics dict.

    sample_stats: list of (tp, conf, pred_cls) triples from batch_statistics.
    Mirrors test_epoch_end's SSD/Retina/v5 branch (LightningFunc/step.py:105-130).
    """
    if not sample_stats:
        return {"precision": 0.0, "recall": 0.0, "mAP": 0.0, "f1": 0.0,
                "per_class_AP": {}}
    tp = np.concatenate([s[0] for s in sample_stats])
    conf = np.concatenate([s[1] for s in sample_stats])
    pred_cls = np.concatenate([s[2] for s in sample_stats])
    target_cls = np.asarray(all_target_classes)
    p, r, ap, f1, classes = ap_per_class(tp, conf, pred_cls, target_cls)
    return {
        "precision": float(p.mean()) if p.size else 0.0,
        "recall": float(r.mean()) if r.size else 0.0,
        "mAP": float(ap.mean()) if ap.size else 0.0,
        "f1": float(f1.mean()) if f1.size else 0.0,
        "per_class_AP": {int(c): float(a) for c, a in zip(classes, ap)},
    }
