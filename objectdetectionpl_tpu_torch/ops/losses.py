"""The YOLOv5 loss: the port of ``objectdetectionpl_tpu/ops/losses.py`` (YOLOv5 part).

A loss is a function ``(outputs, labels, boxes, mask) -> dict[str, scalar
tensor]`` over padded targets (``ops/assignment.py``), with the metric keys
of the JAX package.  Loss terms are computed in the head maps' dtype (bf16
under bf16 compute) and accumulated in f32, as JAX does; nothing syncs with
the host.  The other families' losses come with their slices (ROADMAP A9).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from objectdetectionpl_tpu_torch.models.registry import NOT_PORTED
from objectdetectionpl_tpu_torch.ops import anchors as anchor_lib
from objectdetectionpl_tpu_torch.ops import assignment
from objectdetectionpl_tpu_torch.ops import boxes as box_ops


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


def smooth_bce_targets(eps: float = 0.0):
    """Label-smoothing (positive, negative) targets."""
    return 1.0 - 0.5 * eps, 0.5 * eps


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
        cnt = valid.sum().clamp(min=1.0)

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
        lobj = lobj + obj_elem.mean(dtype=torch.float32).to(pi.dtype)

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


def make_loss(model_name: str, num_classes: int, img_size: int,
              coord_criterion: str = "smooth_l1_loss",
              cls_criterion: str = "bce_loss", anchors=None,
              v3_double_stride: bool = False, **kw):
    """String-config loss factory; YOLOv5 only so far.

    Returns ``(outputs, labels, boxes, mask) -> metrics dict``.  The anchor
    table is copied to each device once, on the first call there.  As in
    the JAX factory, an unknown ``coord_criterion`` raises KeyError for
    every family, and YOLOv5 ignores ``img_size``, the criteria and
    ``v3_double_stride`` (the YOLOv3 anchor flag, ROADMAP A9.1); ``kw``
    goes to :func:`yolov5_loss`.
    """
    if coord_criterion not in COORD_CRITERIA:
        raise KeyError(coord_criterion)
    if model_name in NOT_PORTED:
        raise NotImplementedError(f"{model_name} loss is not ported yet "
                                  f"({NOT_PORTED[model_name]})")
    if model_name != "YOLOv5":
        raise ValueError(f"unknown model {model_name!r}")
    anc = anchor_lib.YOLOV5_ANCHORS if anchors is None else anchors
    on_device = {}

    def loss(outputs, labels, boxes, mask):
        dev = outputs[0].device
        if dev not in on_device:
            on_device[dev] = [torch.as_tensor(a, dtype=torch.float32,
                                              device=dev) for a in anc]
        return yolov5_loss(outputs, labels, boxes, mask,
                           anchors_px=on_device[dev],
                           strides=anchor_lib.YOLOV5_STRIDES,
                           num_classes=num_classes, **kw)

    return loss
