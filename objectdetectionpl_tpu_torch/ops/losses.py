"""Detection losses: the port of ``objectdetectionpl_tpu/ops/losses.py``.

A loss is a function ``(outputs, labels, boxes, mask) -> dict[str, scalar
tensor]`` over padded targets (``ops/assignment.py``), with the metric keys
of the JAX package.  Loss terms are computed in the head maps' dtype (bf16
under bf16 compute) and promoted to f32 where they meet the f32 targets,
as JAX promotes (a bf16 map meets a f32 one-hot or offset target in
f32); nothing syncs with the host.

Under a process group, inside a train step
(``parallel/distributed.py::global_batch``), each rank's loss is its share
of the global batch's: its own numerators over the global normalisers
(positive counts all-reduced by ``batch_sum``; means over the batch or
its elements divided by ``batch_world``, the Loader's shards being
equal).  The ranks' losses then add up to JAX's loss of the concatenated
batch, and their gradients to its gradient.  Elsewhere, and at world
size 1, the normalisers are the rank's own.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from objectdetectionpl_tpu_torch.ops import anchors as anchor_lib
from objectdetectionpl_tpu_torch.ops import assignment
from objectdetectionpl_tpu_torch.ops import boxes as box_ops
from objectdetectionpl_tpu_torch.parallel.distributed import (batch_sum,
                                                              batch_world)


# Probability floor of the -100 log clamp: the smallest normal float32 (JAX
# flushes denormals, so torch's e^-100 would never bind there).
_BCE_FLOOR_P = 1.2e-38


def _safe_log_clamped(p: torch.Tensor) -> torch.Tensor:
    """log(p) clamped at -100, with gradient 0 (not NaN) where clamped: the
    log of the untaken branch sees 1, not 0."""
    unsafe = p < _BCE_FLOOR_P
    return torch.where(unsafe, -100.0, torch.log(torch.where(unsafe, 1.0, p)))


def bce_prob(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCELoss semantics on probabilities (log clamped at -100).
    ``F.binary_cross_entropy`` clamps elsewhere and is not used."""
    return -(t * _safe_log_clamped(p) + (1.0 - t) * _safe_log_clamped(1.0 - p))


def bce_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCEWithLogitsLoss (elementwise, numerically stable)."""
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def focal_bce_logits(x: torch.Tensor, t: torch.Tensor, gamma: float = 1.5,
                     alpha: float = 0.25) -> torch.Tensor:
    """TF-style focal modulation around BCEWithLogits."""
    loss = bce_logits(x, t)
    p = torch.sigmoid(x)
    p_t = t * p + (1 - t) * (1 - p)
    alpha_f = t * alpha + (1 - t) * (1 - alpha)
    return loss * alpha_f * (1.0 - p_t) ** gamma


def mse(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (x - t) ** 2


def smooth_l1(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    d = (x - t).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


COORD_CRITERIA = {"mse_loss": mse, "smooth_l1_loss": smooth_l1}


def softmax_focal(logits: torch.Tensor, y: torch.Tensor, num_classes: int,
                  alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss on a softmax over the C class logits [N, C]; y [N] in
    {0 (background), 1..C}.  Background rows have an all-zero target, so
    they add neither loss nor gradient.  Returns [N, C] elementwise, f32."""
    t = F.one_hot(y.long(), num_classes + 1)[..., 1:].float()
    p = torch.softmax(logits, dim=-1).clamp(1e-7, 1.0 - 1e-7)
    return alpha * (-t * torch.log(p)) * (1.0 - p) ** gamma


def sigmoid_focal(logits: torch.Tensor, y: torch.Tensor, num_classes: int,
                  alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """RetinaNet's focal loss (Lin et al. 2017): per-class sigmoid BCE with
    focal modulation.  logits [N, C]; y [N] in {0 (background), 1..C};
    background rows have all-zero targets, which push every class logit
    down.  Returns [N, C] elementwise, f32."""
    t = F.one_hot(y.long(), num_classes + 1)[..., 1:].float()
    p = torch.sigmoid(logits)
    bce = (logits.clamp(min=0.0) - logits * t
           + torch.log1p(torch.exp(-logits.abs())))
    pt = p * t + (1.0 - p) * (1.0 - t)
    w = alpha * t + (1.0 - alpha) * (1.0 - t)
    return w * (1.0 - pt) ** gamma * bce


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Mean of x over mask m (the global batch's mask in a train step); 0
    when the mask is empty."""
    m = m.to(x.dtype)
    return (x * m).sum() / batch_sum(m.sum()).clamp(min=1.0)


def smooth_bce_targets(eps: float = 0.0):
    """Label-smoothing (positive, negative) targets."""
    return 1.0 - 0.5 * eps, 0.5 * eps


# --- YOLO v2/v3/v4 region loss --------------------------------------------


def decode_yolo_map(x: torch.Tensor, num_anchors: int, num_classes: int):
    """Raw head map [B, A*(5+C), g, g] -> (xy sigmoid, raw wh, conf, cls),
    each [B, A, g, g, ...] in x's dtype."""
    B, _, g, _ = x.shape
    pred = x.reshape(B, num_anchors, 5 + num_classes, g, g)
    pred = pred.permute(0, 1, 3, 4, 2)                  # [B, A, g, g, 5+C]
    xy = torch.sigmoid(pred[..., 0:2])
    wh = pred[..., 2:4]
    conf = torch.sigmoid(pred[..., 4])
    cls = torch.sigmoid(pred[..., 5:])
    return xy, wh, conf, cls


def decode_yolo_boxes(xy: torch.Tensor, wh: torch.Tensor,
                      anchors_grid: torch.Tensor,
                      cap_wh: bool) -> torch.Tensor:
    """[B, A, g, g, 4] grid-unit xywh boxes from :func:`decode_yolo_map`'s
    ``xy`` and raw ``wh``, in their dtype; ``cap_wh`` caps the exp at
    e^20 (the loss's assignment does, the statistics do not)."""
    A, g = xy.shape[1], xy.shape[2]
    anc = anchors_grid.reshape(1, A, 1, 1, 2).to(xy.dtype)
    return torch.cat([xy + box_ops.grid_offsets(g, xy.dtype, xy.device),
                      torch.exp(wh.clamp(max=20.0) if cap_wh else wh) * anc],
                     dim=-1)


def region_loss(x: torch.Tensor, labels: torch.Tensor, boxes: torch.Tensor,
                mask: torch.Tensor, anchors_grid: torch.Tensor,
                num_classes: int, coord_criterion=mse,
                cls_criterion=bce_prob, conf_criterion=bce_prob,
                ignore_thres: float = 0.5, obj_scale: float = 1.0,
                noobj_scale: float = 100.0) -> dict:
    """Single-scale YOLO region loss over a raw map [B, A*(5+C), g, g];
    ``anchors_grid`` [A, 2] float32 in grid units, on x's device.

    The assignment sees detached boxes and classes, with the exp of ``wh``
    capped at e^20 (the boxes feed only its metrics); the loss terms use
    the raw ``wh``.
    """
    A = anchors_grid.shape[0]
    xy, wh, conf, cls = decode_yolo_map(x, A, num_classes)
    pred_boxes = decode_yolo_boxes(xy, wh, anchors_grid, cap_wh=True)
    anc = anchors_grid.reshape(1, A, 1, 1, 2).to(x.dtype)

    tgt = assignment.build_targets_yolo(
        pred_boxes.detach(), cls.detach(), labels, boxes, mask,
        anchors_grid, ignore_thres)
    obj = tgt.obj_mask
    noobj = tgt.noobj_mask.to(x.dtype)

    loss_x = _masked_mean(coord_criterion(xy[..., 0], tgt.tx), obj)
    loss_y = _masked_mean(coord_criterion(xy[..., 1], tgt.ty), obj)
    loss_w = _masked_mean(coord_criterion(wh[..., 0], tgt.tw), obj)
    loss_h = _masked_mean(coord_criterion(wh[..., 1], tgt.th), obj)
    loss_conf_obj = _masked_mean(conf_criterion(conf, obj), obj)
    loss_conf_noobj = _masked_mean(conf_criterion(conf, obj), noobj)
    loss_conf = obj_scale * loss_conf_obj + noobj_scale * loss_conf_noobj
    loss_cls = _masked_mean(cls_criterion(cls, tgt.tcls),
                            obj[..., None].expand(cls.shape))
    total = loss_x + loss_y + loss_w + loss_h + loss_conf + loss_cls

    # "Size": sqrt-wh error at assigned cells
    pw = torch.sqrt(pred_boxes[..., 2:4].abs() + 1e-32)
    tw_grid = torch.sqrt(
        (torch.exp(torch.stack([tgt.tw, tgt.th], -1)) * anc).abs() + 1e-32)
    wh_loss = _masked_mean(coord_criterion(pw, tw_grid).mean(-1), obj)

    return {"loss": total, "Localization": loss_x + loss_y, "Size": wh_loss,
            "Conf": loss_conf, "Classification": loss_cls,
            "Conf_obj": loss_conf_obj, "Conf_noobj": loss_conf_noobj}


def multiscale_region_loss(outputs: Sequence[torch.Tensor], labels, boxes,
                           mask, anchors_grid_per_scale, num_classes: int,
                           **kw) -> dict:
    """Per-scale region loss; every metric, the loss included, is the mean
    over the scales."""
    acc = None
    for out, anc in zip(outputs, anchors_grid_per_scale):
        m = region_loss(out, labels, boxes, mask, anc, num_classes, **kw)
        acc = m if acc is None else {k: acc[k] + m[k] for k in m}
    return {k: v / len(outputs) for k, v in acc.items()}


def yolo_anchors_grid(model_name: str, anchors=None,
                      v3_double_stride: bool = False):
    """The region losses' per-scale anchors in grid units, float32 numpy,
    in the model's output order (YOLOv2: one scale, already grid units).

    ``v3_double_stride`` divides YOLOv3's anchors by the stride twice
    (8-32x smaller), as the reference YOLOv3 does: once when it builds the
    model, again in its loss."""
    if model_name == "YOLOv2":
        return [np.asarray(anchor_lib.YOLOV2_ANCHORS if anchors is None
                           else anchors, dtype=np.float32)]
    if model_name == "YOLOv3":
        anc = anchor_lib.YOLOV3_ANCHORS if anchors is None else anchors
        return [np.asarray(anc[i], np.float32) / (s * s if v3_double_stride
                                                  else s)
                for i, s in enumerate(anchor_lib.YOLOV3_STRIDES)]
    if model_name == "YOLOv4":
        anc = anchor_lib.YOLOV4_ANCHORS if anchors is None else anchors
        return [np.asarray(anc[list(m)], np.float32) / s for m, s in
                zip(anchor_lib.YOLOV4_ANCH_MASKS, anchor_lib.YOLOV4_STRIDES)]
    raise ValueError(f"unknown model {model_name!r}")


# --- YOLOv5 loss -----------------------------------------------------------


def yolov5_loss(outputs: Sequence[torch.Tensor], labels: torch.Tensor,
                boxes: torch.Tensor, mask: torch.Tensor, anchors_px=None,
                strides=(8, 16, 32), num_classes: int = 80,
                fl_gamma: float = 1.5, label_smoothing: float = 0.0,
                box_gain: float = 0.05, obj_gain: float = 1.0,
                cls_gain: float = 0.58, anchor_t: float = 4.0) -> dict:
    """YOLOv5 loss over 3 head maps [B, 3, g, g, 5+C].

    GIoU box loss with the (sigmoid*2-0.5, (sigmoid*2)^2*anchor) decode,
    objectness BCE against the detached, clipped GIoU at assigned cells,
    focal-wrapped BCE class loss; gains lbox 0.05 / lobj 1.0 / lcls 0.58.
    ``anchors_px[i]`` (input pixels) may be an array or a tensor; a tensor
    already on the maps' device is used without a copy.

    Where two slots hit one cell, ``tobj`` keeps the max.  Invalid slots
    (JAX scatters them to a dropped image index) scatter 0: every target is
    >= 0 and the map starts at 0, so an ``amax`` with 0 changes nothing.
    """
    if anchors_px is None:
        anchors_px = anchor_lib.YOLOV5_ANCHORS
    cp, cn = smooth_bce_targets(label_smoothing)
    crit = (functools.partial(focal_bce_logits, gamma=fl_gamma)
            if fl_gamma > 0 else bce_logits)

    dev = outputs[0].device
    lcls = torch.zeros((), dtype=torch.float32, device=dev)
    lbox = torch.zeros((), dtype=torch.float32, device=dev)
    lobj = torch.zeros((), dtype=torch.float32, device=dev)
    for i, pi in enumerate(outputs):
        g = pi.shape[2]
        anc_grid = torch.as_tensor(anchors_px[i], dtype=torch.float32,
                                   device=dev) / float(strides[i])
        t = assignment.build_targets_v5(labels, boxes, mask, anc_grid, g,
                                        anchor_t)
        valid = t.valid.to(torch.float32)
        cnt = batch_sum(valid.sum()).clamp(min=1.0)

        ps = pi[t.b, t.a, t.gj, t.gi]                       # [K, 5+C]
        pxy = torch.sigmoid(ps[:, :2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * t.anch
        pbox = torch.cat([pxy, pwh], dim=1)
        giou = box_ops.iou_v5(pbox, t.tbox, xyxy=False, giou=True)  # [K]
        lbox = lbox + ((1.0 - giou) * valid).sum() / cnt

        giou_t = torch.where(t.valid, giou.detach().clamp(min=0.0), 0.0)
        B, A = pi.shape[0], pi.shape[1]
        cell = ((t.b * A + t.a) * g + t.gj) * g + t.gi
        tobj = torch.zeros(B * A * g * g, dtype=pi.dtype, device=dev)
        tobj = tobj.scatter_reduce(0, cell, giou_t.to(pi.dtype), "amax")
        obj_elem = crit(pi[..., 4], tobj.view(B, A, g, g))
        lobj = lobj + (obj_elem.mean(dtype=torch.float32)
                       / batch_world()).to(pi.dtype)

        if num_classes > 1:
            tcl = torch.full((ps.shape[0], num_classes), cn, dtype=pi.dtype,
                             device=dev)
            tcl.scatter_(1, t.tcls.long().clamp(0, num_classes - 1)[:, None],
                         cp)
            cls_elem = crit(ps[:, 5:], tcl)                 # [K, C]
            lcls = lcls + (cls_elem * valid[:, None]).sum() / (
                cnt * num_classes)

    lbox = lbox * box_gain
    lobj = lobj * obj_gain
    lcls = lcls * cls_gain
    return {"loss": lbox + lobj + lcls, "Localization": lbox,
            "Classification": lcls, "Conf_obj": lobj}


# --- SSD loss ---------------------------------------------------------------


def ssd_loss(outputs, labels: torch.Tensor, boxes: torch.Tensor,
             mask: torch.Tensor, default_xywh, num_classes: int,
             coord_criterion=smooth_l1, cls_mode: str = "ce",
             match_thresh: float = 0.5, neg_ratio: int = 3) -> dict:
    """SSD multibox loss with 3:1 hard-negative mining.

    outputs: (loc [B, D, 4], cls [B, D, 1+C]), class channel 0 background.
    ``cls_mode`` "ce" (cross-entropy over 1+C channels) or "focal"
    (:func:`softmax_focal` over the C foreground channels, summed per box).
    Per image: localization over the positives and classification over the
    positives plus the ``neg_ratio * positives`` hardest negatives (a full
    descending sort and a rank mask), both over max(positives, 1); an image
    without targets adds the mined negatives' zero count and no
    localization.  The metrics are the means over the images.
    """
    loc_p, cls_p = outputs
    B, D = loc_p.shape[:2]
    dev = loc_p.device
    dbox = torch.as_tensor(default_xywh, dtype=torch.float32, device=dev)
    m = assignment.ssd_match(dbox, labels, boxes, mask, match_thresh)
    n_matched = m.matched.sum(dim=1)                            # [B]
    has_ann = mask.any(dim=1)
    n = torch.where(has_ann, n_matched, 1).clamp(min=1).float()

    reg_elem = coord_criterion(loc_p, m.true_offsets).sum(-1)   # [B, D]
    reg = (reg_elem * m.matched).sum(dim=1) / n
    reg = torch.where(has_ann, reg, 0.0)

    if cls_mode == "focal":
        # channel 0 (background) is unused in focal mode
        cls_elem = softmax_focal(cls_p[..., 1:].reshape(B * D, num_classes),
                                 m.true_classes.reshape(-1), num_classes
                                 ).sum(-1).view(B, D)
    else:
        logp = torch.log_softmax(cls_p, dim=-1)
        cls_elem = -torch.gather(logp, 2, m.true_classes[..., None])[..., 0]

    pos_sum = (cls_elem * m.matched).sum(dim=1)
    neg = torch.where(m.matched, -math.inf, cls_elem)
    neg_sorted = torch.sort(neg, dim=1, descending=True).values
    rank = torch.arange(D, device=dev)
    k = neg_ratio * torch.where(has_ann, n_matched, 0)
    neg_sum = torch.where(rank[None] < k[:, None], neg_sorted, 0.0).sum(dim=1)
    cls_loss = ((pos_sum + neg_sum) / n).mean() / batch_world()
    loc_loss = reg.mean() / batch_world()
    return {"loss": cls_loss + loc_loss, "Localization": loc_loss,
            "Classification": cls_loss}


# --- RetinaNet loss ----------------------------------------------------------


def retinanet_loss(outputs, labels: torch.Tensor, boxes: torch.Tensor,
                   mask: torch.Tensor, anchors_xywh, num_classes: int,
                   img_size: float, coord_criterion=smooth_l1,
                   focal: str = "softmax") -> dict:
    """RetinaNet focal loss + box regression, both over max(positives, 1)
    of the whole batch.

    outputs: (loc [B, A, 4], cls [B, A, C]).  ``focal`` "softmax"
    (:func:`softmax_focal`, no gradient on background rows) or "sigmoid"
    (:func:`sigmoid_focal`, the default of :func:`make_loss`); anchors in
    the ignore band add nothing.
    """
    loc_p, cls_p = outputs
    dev = loc_p.device
    anc = torch.as_tensor(anchors_xywh, dtype=torch.float32, device=dev)
    match = assignment.retina_match(anc, labels, boxes, mask, img_size)

    pos = match.cls_targets > 0                                 # [B, A]
    num_pos = batch_sum(pos.sum().float()).clamp(min=1.0)
    loc_elem = coord_criterion(loc_p, match.loc_targets).sum(-1)
    loc_loss = (loc_elem * pos).sum()

    not_ignored = match.cls_targets > -1
    focal_fn = sigmoid_focal if focal == "sigmoid" else softmax_focal
    cls_elem = focal_fn(cls_p.reshape(-1, num_classes),
                        match.cls_targets.clamp(min=0).reshape(-1),
                        num_classes).sum(-1)
    cls_loss = (cls_elem * not_ignored.reshape(-1)).sum()
    return {"loss": (loc_loss + cls_loss) / num_pos,
            "Localization": loc_loss / num_pos,
            "Classification": cls_loss / num_pos}


def make_loss(model_name: str, num_classes: int, img_size: int,
              coord_criterion: str = "smooth_l1_loss",
              cls_criterion: str = "bce_loss", anchors=None,
              v3_double_stride: bool = False, **kw):
    """String-config loss factory for the six families.

    Returns ``(outputs, labels, boxes, mask) -> metrics dict``.  The anchor
    tables and default boxes are copied to each device once, on the first
    call there.  As in the JAX factory, an unknown ``coord_criterion``
    raises KeyError for every family; the YOLO families ignore ``img_size``
    and ``cls_criterion``, and all but YOLOv3 ignore ``v3_double_stride``
    (:func:`yolo_anchors_grid`).  YOLOv2/v3/v4, SSD and RetinaNet take
    ``coord_criterion`` for the box terms; YOLOv5 ignores it.  SSD uses
    the focal classification for ``cls_criterion="focal_loss"``, else
    cross-entropy; RetinaNet's ``focal`` defaults to "sigmoid".  ``kw``
    goes to the family's loss function.
    """
    coord = COORD_CRITERIA[coord_criterion]
    on_device = {}

    def tables(dev, arrays):
        if dev not in on_device:
            on_device[dev] = [torch.as_tensor(a, dtype=torch.float32,
                                              device=dev) for a in arrays]
        return on_device[dev]

    if model_name == "SSD":
        dboxes = anchor_lib.ssd_dboxes() if anchors is None else anchors
        mode = "focal" if cls_criterion == "focal_loss" else "ce"

        def ssd(outputs, labels, boxes, mask):
            return ssd_loss(outputs, labels, boxes, mask,
                            tables(outputs[0].device, [dboxes])[0],
                            num_classes, coord_criterion=coord,
                            cls_mode=mode, **kw)
        return ssd

    if model_name == "RetinaNet":
        anc = (anchor_lib.retina_anchors(img_size) if anchors is None
               else anchors)
        kw.setdefault("focal", "sigmoid")

        def retina(outputs, labels, boxes, mask):
            return retinanet_loss(outputs, labels, boxes, mask,
                                  tables(outputs[0].device, [anc])[0],
                                  num_classes, img_size,
                                  coord_criterion=coord, **kw)
        return retina

    if model_name != "YOLOv5":
        per_scale = yolo_anchors_grid(model_name, anchors, v3_double_stride)

        def region(outputs, labels, boxes, mask):
            if model_name == "YOLOv2":                  # one map
                return region_loss(outputs, labels, boxes, mask,
                                   tables(outputs.device, per_scale)[0],
                                   num_classes, coord_criterion=coord, **kw)
            return multiscale_region_loss(
                outputs, labels, boxes, mask,
                tables(outputs[0].device, per_scale), num_classes,
                coord_criterion=coord, **kw)

        return region

    anc = anchor_lib.YOLOV5_ANCHORS if anchors is None else anchors

    def loss(outputs, labels, boxes, mask):
        return yolov5_loss(outputs, labels, boxes, mask,
                           anchors_px=tables(outputs[0].device, anc),
                           strides=anchor_lib.YOLOV5_STRIDES,
                           num_classes=num_classes, **kw)

    return loss
