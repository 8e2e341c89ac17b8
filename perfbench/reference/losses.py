"""The detection losses and target assignment in plain float32 PyTorch:
the frozen reference of the port's ``ops/losses.py`` (``yolov5_loss``,
``retinanet_loss`` with the sigmoid focal loss) and ``ops/assignment.py``
(``build_targets_v5``, ``retina_match``).

Targets are padded: labels [B, M] (0-based), boxes [B, M, 4] center-form
normalized, mask [B, M].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-16


def xywh_to_xyxy(box):
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou(box1, box2):
    """Elementwise GIoU of center-form boxes (no +1 convention)."""
    b1, b2 = xywh_to_xyxy(box1), xywh_to_xyxy(box2)
    inter = ((torch.minimum(b1[..., 2], b2[..., 2])
              - torch.maximum(b1[..., 0], b2[..., 0])).clamp(min=0)
             * (torch.minimum(b1[..., 3], b2[..., 3])
                - torch.maximum(b1[..., 1], b2[..., 1])).clamp(min=0))
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    union = (w1 * h1 + EPS) + w2 * h2 - inter
    iou = inter / union
    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0],
                                                             b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1],
                                                             b2[..., 1])
    c_area = cw * ch + EPS
    return iou - (c_area - union) / c_area


def bce_logits(x, t):
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def focal_bce_logits(x, t, gamma: float, alpha: float = 0.25):
    """BCE with logits, times ``alpha_t (1 - p_t)^gamma``."""
    p = torch.sigmoid(x)
    p_t = t * p + (1 - t) * (1 - p)
    alpha_f = t * alpha + (1 - t) * (1 - alpha)
    return bce_logits(x, t) * alpha_f * (1.0 - p_t) ** gamma


def build_targets_v5(labels, boxes, mask, anchors_layer, g: int,
                     anchor_t: float):
    """YOLOv5's 'rect4' assignment for one layer, as fixed-size slots over
    (B, M, A, 3): the centre cell and the one x and one y neighbour nearer
    the box centre, each kept where the box's wh ratio to the anchor is
    under ``anchor_t`` and the neighbour lies in the grid.  Returns (b, a,
    gj, gi, tbox [n, 4], anch [n, 2], tcls, valid)."""
    B, M = labels.shape
    A = anchors_layer.shape[0]
    gsz = float(g)
    t = boxes * gsz
    gxy, gwh = t[..., :2], t[..., 2:4]
    r = gwh[:, :, None, :] / anchors_layer[None, None]
    base = mask[:, :, None] & (torch.maximum(r, 1.0 / r).amax(-1) < anchor_t)
    lo = gxy % 1.0 < 0.5
    sgn = torch.where(lo, 1.0, -1.0)
    in_rng = torch.where(lo, gxy > 1.0, gxy < gsz - 1.0)
    variant_ok = torch.stack([torch.ones_like(in_rng[..., 0]),
                              in_rng[..., 0], in_rng[..., 1]], -1)
    zero = torch.zeros_like(sgn[..., 0])
    offs = torch.stack([torch.stack([zero, zero], -1),
                        torch.stack([sgn[..., 0], zero], -1),
                        torch.stack([zero, sgn[..., 1]], -1)], 2) * 0.5
    valid = base[..., None] & variant_ok[:, :, None, :]        # [B, M, A, 3]
    gij = torch.floor(gxy[:, :, None, :] - offs)               # [B, M, 3, 2]
    shape = (B, M, A, 3)
    gi = gij[..., 0].long()[:, :, None, :].expand(shape)
    gj = gij[..., 1].long()[:, :, None, :].expand(shape)
    dxy = gxy[:, :, None, :] - gij
    tbox = torch.cat([dxy[:, :, None].expand(B, M, A, 3, 2),
                      gwh[:, :, None, None].expand(B, M, A, 3, 2)], -1)
    dev = boxes.device
    b = torch.arange(B, device=dev)[:, None, None, None].expand(shape)
    a = torch.arange(A, device=dev)[None, None, :, None].expand(shape)
    anch = anchors_layer[None, None, :, None].expand(B, M, A, 3, 2)
    n = B * M * A * 3
    return (b.reshape(n), a.reshape(n), gj.reshape(n).clamp(0, g - 1),
            gi.reshape(n).clamp(0, g - 1), tbox.reshape(n, 4),
            anch.reshape(n, 2), labels[:, :, None, None].expand(shape)
            .reshape(n), valid.reshape(n))


def yolov5_loss(outputs, labels, boxes, mask, cfg: dict) -> torch.Tensor:
    """The YOLOv5 loss of a configuration's ``loss`` section: GIoU box loss
    over the assigned slots, focal BCE objectness against the detached
    GIoU clipped at 0 (a cell's largest), focal BCE classes; each term
    times its gain."""
    m, L = cfg["model"], cfg["loss"]
    C = m["num_classes"]
    dev = outputs[0].device
    lbox = lobj = lcls = torch.zeros((), device=dev)
    crit = lambda x, t: focal_bce_logits(x, t, L["fl_gamma"])
    for i, pi in enumerate(outputs):
        pi = pi.float()
        g = pi.shape[2]
        anc = torch.tensor(m["anchors"][i], dtype=torch.float32,
                           device=dev) / float(m["strides"][i])
        b, a, gj, gi, tbox, anch, tcls, valid = build_targets_v5(
            labels, boxes, mask, anc, g, L["anchor_t"])
        v = valid.float()
        cnt = v.sum().clamp(min=1.0)
        ps = pi[b, a, gj, gi]
        pxy = torch.sigmoid(ps[:, :2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * anch
        gi_ = giou(torch.cat([pxy, pwh], 1), tbox)
        lbox = lbox + ((1.0 - gi_) * v).sum() / cnt
        B, A = pi.shape[0], pi.shape[1]
        cell = ((b * A + a) * g + gj) * g + gi
        tobj = torch.zeros(B * A * g * g, device=dev).scatter_reduce(
            0, cell, torch.where(valid, gi_.detach().clamp(min=0.0), 0.0),
            "amax")
        lobj = lobj + crit(pi[..., 4], tobj.view(B, A, g, g)).mean()
        tcl = F.one_hot(tcls.long().clamp(0, C - 1), C).float()
        lcls = lcls + (crit(ps[:, 5:], tcl) * v[:, None]).sum() / (cnt * C)
    return (lbox * L["box_gain"] + lobj * L["obj_gain"]
            + lcls * L["cls_gain"])


def pairwise_iou_plus1(box1, box2):
    """[B, N, M] IoU with the +1-pixel convention (xyxy), no union eps."""
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:4], box2[..., None, :, 2:4])
    wh = (rb - lt + 1).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (box1[..., 2] - box1[..., 0] + 1) * (box1[..., 3] - box1[..., 1]
                                                 + 1)
    area2 = (box2[..., 2] - box2[..., 0] + 1) * (box2[..., 3] - box2[..., 1]
                                                 + 1)
    return inter / (area1[..., :, None] + area2[..., None, :] - inter)


def retina_match(anchors_xywh, labels, boxes, mask, img_size: float):
    """Max-IoU matching: IoU >= 0.5 the target's class 1..C, (0.4, 0.5)
    ignored (-1), the rest background (0); returns (loc_targets [B, A, 4],
    cls_targets [B, A])."""
    B, A = labels.shape[0], anchors_xywh.shape[0]
    boxes_px = boxes * img_size
    ious = pairwise_iou_plus1(xywh_to_xyxy(anchors_xywh)[None].expand(
        B, A, 4), xywh_to_xyxy(boxes_px))
    ious = torch.where(mask[:, None, :], ious, -1.0)
    max_ious = ious.amax(dim=2)
    max_ids = ious.argmax(dim=2)         # the first max
    matched = torch.gather(boxes_px, 1, max_ids[..., None].expand(B, A, 4))
    matched = torch.cat([matched[..., :2], matched[..., 2:4].clamp(min=1e-6)],
                        -1)
    loc = torch.cat([(matched[..., :2] - anchors_xywh[..., :2])
                     / anchors_xywh[..., 2:4],
                     torch.log(matched[..., 2:4] / anchors_xywh[..., 2:4])],
                    -1)
    cls = 1 + torch.gather(labels.long(), 1, max_ids)
    cls = torch.where(max_ious < 0.5, 0, cls)
    cls = torch.where((max_ious > 0.4) & (max_ious < 0.5), -1, cls)
    cls = torch.where(mask.any(dim=1, keepdim=True), cls, 0)
    return loc, cls


def sigmoid_focal(logits, t, alpha: float, gamma: float):
    p = torch.sigmoid(logits)
    pt = p * t + (1.0 - p) * (1.0 - t)
    w = alpha * t + (1.0 - alpha) * (1.0 - t)
    return w * (1.0 - pt) ** gamma * bce_logits(logits, t)


def retinanet_loss(outputs, labels, boxes, mask, cfg: dict,
                   anchors_xywh: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 box regression over the positives plus the sigmoid focal
    loss over every anchor not ignored, both over max(positives, 1)."""
    m, L = cfg["model"], cfg["loss"]
    C = m["num_classes"]
    loc_p, cls_p = (o.float() for o in outputs)
    loc_t, cls_t = retina_match(anchors_xywh, labels, boxes, mask,
                                float(m["img_size"]))
    pos = cls_t > 0
    num_pos = pos.sum().float().clamp(min=1.0)
    d = (loc_p - loc_t).abs()
    loc_elem = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum(-1)
    onehot = F.one_hot(cls_t.clamp(min=0), C + 1)[..., 1:].float()
    cls_elem = sigmoid_focal(cls_p, onehot, L["focal_alpha"],
                             L["focal_gamma"]).sum(-1)
    return ((loc_elem * pos).sum() + (cls_elem * (cls_t > -1)).sum()) \
        / num_pos
