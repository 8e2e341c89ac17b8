"""Decodes and batched greedy NMS on tensors.

The serving part of ``objectdetectionpl_tpu/ops/nms.py``: YOLO decoded
predictions ``[B, N, 5+C]`` -> top-k candidates -> class-aware, obj-weighted
merge greedy NMS (``yolo_nms``); SSD / RetinaNet offsets and class logits ->
anchor decode -> top-k -> class-agnostic greedy NMS (``anchor_nms``); both
with the +1-pixel IoU, as fixed-size ``[B, K, ...]`` results with a
validity mask.  The suppression scan is ``ops/cuda/nms_kernel.greedy_nms``:
the CUDA kernel for CUDA tensors, its plain version for CPU tensors.

Candidate selection is exact and stable: equal scores keep the lower index
first, as ``lax.top_k`` does (bf16 scores tie often).  The TPU's
``approx_max_k`` has no counterpart here.  :func:`decode_select_yolov5`
ranks on the raw YOLOv5 maps and decodes only the selected rows.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from objectdetectionpl_tpu_torch.device import device_table
from objectdetectionpl_tpu_torch.ops import boxes as box_ops
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel

NEG_INF = -1e9

_ANCHORS: dict = {}   # (anchor pixels, dtype, device) -> [A, 2] tensor


class NMSResult(NamedTuple):
    boxes: torch.Tensor   # [B, K, 4] xyxy
    obj: torch.Tensor     # [B, K] objectness
    scores: torch.Tensor  # [B, K]
    labels: torch.Tensor  # [B, K] int32
    valid: torch.Tensor   # [B, K] bool


class YoloCandidates(NamedTuple):
    """The top-k rows ``yolo_nms`` hands to the suppression scan."""
    boxes: torch.Tensor   # [B, K, 4] xyxy, predictions' dtype
    scores: torch.Tensor  # [B, K] obj * max_cls, NEG_INF below conf_thres
    labels: torch.Tensor  # [B, K] int32
    obj: torch.Tensor     # [B, K]
    cls: torch.Tensor     # [B, K] max class confidence
    weight: torch.Tensor  # [B, K] merge weight: obj, 0 for invalid rows

    def nms_inputs(self):
        """(boxes, scores, labels, obj) as ``greedy_nms`` takes them:
        contiguous, float32 (the scan runs in f32 whatever the model's
        dtype) and int32 labels."""
        f32 = lambda t: t.float().contiguous()
        return (f32(self.boxes), f32(self.scores), self.labels.contiguous(),
                f32(self.weight))


def anchor_table(anc_px, dtype: torch.dtype, device) -> torch.Tensor:
    """Anchor sizes in pixels ``[A, 2]`` as a tensor in ``dtype`` on
    ``device``, copied there once (``device.device_table``)."""
    a = np.asarray(anc_px)
    return device_table(_ANCHORS, (a.tobytes(), a.dtype.str, a.shape, dtype,
                                   torch.device(device)),
                        lambda: torch.as_tensor(a, dtype=dtype,
                                                device=device))


def decode_yolo_predictions(outputs: Sequence[torch.Tensor], anchors_px,
                            strides, num_classes: int) -> torch.Tensor:
    """Decode YOLOv2/v3/v4 raw maps [B, A*(5+C), g, g] to [B, N, 5+C]
    pixel-space rows: xy = (sigmoid + grid) * stride, wh = exp * anchor,
    obj/cls = sigmoid.  Computed in the maps' dtype, as the JAX decode
    is (the anchors too: pixels cast to it, then divided by the stride)."""
    parts = []
    for x, anc_px, stride in zip(outputs, anchors_px, strides):
        B, _, g, _ = x.shape
        A = len(anc_px)
        pred = x.reshape(B, A, 5 + num_classes, g, g).permute(0, 1, 3, 4, 2)
        grid = box_ops.grid_offsets(g, x.dtype, x.device)
        anc = anchor_table(anc_px, x.dtype, x.device).reshape(
            1, A, 1, 1, 2) / stride
        xy = (torch.sigmoid(pred[..., :2]) + grid) * stride
        wh = torch.exp(pred[..., 2:4]) * anc * stride
        dec = torch.cat([xy, wh, torch.sigmoid(pred[..., 4:])], dim=-1)
        parts.append(dec.reshape(B, -1, 5 + num_classes))
    return torch.cat(parts, dim=1)


def decode_yolov5_predictions(outputs: Sequence[torch.Tensor], anchors_px,
                              strides, num_classes: int) -> torch.Tensor:
    """Decode YOLOv5 maps [B, 3, g, g, 5+C] to [B, N, 5+C] pixel-space rows.

    xy = (sigmoid*2 - 0.5 + grid) * stride; wh = (sigmoid*2)^2 * anchor;
    obj/cls = sigmoid.  Computed in the maps' dtype, as the JAX decode is.
    """
    parts = []
    for x, anc_px, stride in zip(outputs, anchors_px, strides):
        B, A, g, _, _ = x.shape
        grid = box_ops.grid_offsets(g, x.dtype, x.device)
        anc = anchor_table(anc_px, x.dtype, x.device).reshape(1, A, 1, 1, 2)
        sig = torch.sigmoid(x)
        xy = (sig[..., :2] * 2.0 - 0.5 + grid) * stride
        wh = (sig[..., 2:4] * 2.0) ** 2 * anc
        dec = torch.cat([xy, wh, sig[..., 4:]], dim=-1)
        parts.append(dec.reshape(B, -1, 5 + num_classes))
    return torch.cat(parts, dim=1)


def _select_top_k(score: torch.Tensor, k: int):
    """(values, indices) of the k best scores per row, ties by lower index."""
    values, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def decode_select_yolov5(outputs: Sequence[torch.Tensor], anchors_px,
                         strides, num_classes: int, top_k: int = 300,
                         conf_thres: float = 0.5) -> torch.Tensor:
    """Score -> top-k -> gather -> decode: the serving-tail form of
    :func:`decode_yolov5_predictions`, feeding :func:`yolo_nms`.

    The score is taken on the raw maps, ``sigmoid(obj) * sigmoid(max
    cls)`` where ``sigmoid(obj) >= conf_thres`` (``max(sigmoid(z)) ==
    sigmoid(max(z))``), the ``top_k`` best rows over all maps are picked
    by the exact, stable :func:`_select_top_k`, and only their raw rows
    are gathered and decoded, grid cell and anchor recovered from the flat
    index.  An image with fewer than ``top_k`` rows over the threshold
    gathers rows that fail it in :func:`yolo_nms`, so the detections are
    the dense chain's.  Returns ``[B, min(top_k, N), 5+C]`` in the maps'
    dtype.
    """
    B = outputs[0].shape[0]
    scores = []
    for x in outputs:
        obj = torch.sigmoid(x[..., 4])
        cls = torch.sigmoid(x[..., 5:].amax(dim=-1))
        scores.append(torch.where(obj >= conf_thres, obj * cls,
                                  NEG_INF).reshape(B, -1))
    score = torch.cat(scores, dim=1)
    _, idx = _select_top_k(score, min(top_k, score.shape[1]))   # [B, K]

    out = outputs[0].new_zeros((B, idx.shape[1], 5 + num_classes))
    image = torch.arange(B, device=idx.device)[:, None]
    offset = 0
    for x, anc_px, stride in zip(outputs, anchors_px, strides):
        _, A, g, _, _ = x.shape
        n = A * g * g
        local = idx - offset
        in_scale = (local >= 0) & (local < n)
        li = local.clamp(0, n - 1)
        a, rem = li // (g * g), li % (g * g)
        gy, gx = rem // g, rem % g
        rows = x[image, a, gy, gx]                      # [B, K, 5+C]
        gxy = torch.stack([gx, gy], dim=-1).to(rows.dtype)
        anc = anchor_table(anc_px, rows.dtype, rows.device)[a]
        sig = torch.sigmoid(rows)
        xy = (sig[..., :2] * 2.0 - 0.5 + gxy) * stride
        wh = (sig[..., 2:4] * 2.0) ** 2 * anc
        dec = torch.cat([xy, wh, sig[..., 4:]], dim=-1)
        out = torch.where(in_scale[..., None], dec, out)
        offset += n
    return out


def yolo_candidates(predictions: torch.Tensor, conf_thres: float = 0.5,
                    top_k: int = 300) -> YoloCandidates:
    """Rank rows by obj * max_cls among obj >= conf_thres and gather the
    top ``top_k`` (all in the predictions' dtype)."""
    top_k = min(top_k, predictions.shape[1])
    boxes = box_ops.xywh_to_xyxy(predictions[..., :4])
    obj = predictions[..., 4]
    cls_conf = predictions[..., 5:].amax(dim=-1)
    label = predictions[..., 5:].argmax(dim=-1).to(torch.int32)
    score = torch.where(obj >= conf_thres, obj * cls_conf, NEG_INF)
    top_scores, idx = _select_top_k(score, top_k)
    take = lambda t: torch.gather(t, 1, idx)
    tb = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    to = take(obj)
    # Compared in the scores' dtype: in bf16, NEG_INF itself rounds to
    # -998244352, which is what the masked rows hold.
    weight = torch.where(top_scores > NEG_INF, to, 0.0)
    return YoloCandidates(tb, top_scores, take(label), to, take(cls_conf),
                          weight)


def yolo_nms(predictions: torch.Tensor, conf_thres: float = 0.5,
             nms_thres: float = 0.4, top_k: int = 300) -> NMSResult:
    """Batched YOLO weighted-merge NMS over decoded predictions [B, N, 5+C].

    Candidates are ranked by obj_conf * max_cls_conf; a kept box absorbs
    the same-label boxes with IoU > nms_thres that it suppresses, as an
    obj-weighted mean.  The scan runs in float32 whatever the input dtype.
    """
    c = yolo_candidates(predictions, conf_thres, top_k)
    kept_boxes, keep = nms_kernel.greedy_nms(
        *c.nms_inputs(), nms_thresh=nms_thres, class_aware=True, merge=True,
        plus1=1.0)
    v = keep & (c.scores > NEG_INF)
    return NMSResult(kept_boxes, torch.where(v, c.obj, 0.0),
                     torch.where(v, c.cls, 0.0), c.labels, v)


class AnchorCandidates(NamedTuple):
    """The top-k rows ``anchor_nms`` hands to the suppression scan."""
    boxes: torch.Tensor   # [B, K, 4] xyxy, f32
    scores: torch.Tensor  # [B, K] best class sigmoid (logits' dtype),
                          # NEG_INF below the class threshold
    labels: torch.Tensor  # [B, K] int32

    def nms_inputs(self):
        """(boxes, scores, labels, obj) as ``greedy_nms`` takes them:
        contiguous, scores in f32 (the scan runs in f32 whatever the
        model's dtype), obj 0."""
        return (self.boxes.float().contiguous(),
                self.scores.float().contiguous(), self.labels.contiguous(),
                torch.zeros(self.scores.shape, dtype=torch.float32,
                            device=self.scores.device))


def anchor_candidates(loc_preds: torch.Tensor, cls_preds: torch.Tensor,
                      anchors_xywh, top_k: int = 100,
                      class_thresh: float = 0.45,
                      decode=box_ops.ssd_decode, use_variance: bool = False,
                      scale: float = 1.0) -> AnchorCandidates:
    """Each row scores its best class sigmoid (``class_thresh`` masks lower
    ones to NEG_INF, in the logits' dtype); the ``top_k`` best rows (ties
    by lower index) are decoded (``ssd_decode`` without the variances
    unless ``use_variance``, or ``decode(offsets, anchors)``) in f32,
    corner-form times ``scale``.  The rows are gathered before the decode,
    which is elementwise, so the boxes equal a decode of every anchor
    followed by the gather."""
    anc = torch.as_tensor(anchors_xywh, dtype=torch.float32,
                          device=loc_preds.device)
    top_k = min(top_k, anc.shape[0])
    probs = torch.sigmoid(cls_preds)
    score = probs.amax(dim=-1)
    label = probs.argmax(dim=-1).to(torch.int32)   # first max, as jnp
    score = torch.where(score > class_thresh, score, NEG_INF)
    top_scores, idx = _select_top_k(score, top_k)
    loc = torch.gather(loc_preds, 1, idx[..., None].expand(-1, -1, 4))
    if decode is box_ops.ssd_decode:
        xywh = box_ops.ssd_decode(loc, anc[idx], use_variance)
    else:
        xywh = decode(loc, anc[idx])
    return AnchorCandidates(box_ops.xywh_to_xyxy(xywh) * scale, top_scores,
                            torch.gather(label, 1, idx))


def anchor_nms(loc_preds: torch.Tensor, cls_preds: torch.Tensor,
               anchors_xywh, top_k: int = 100, nms_thresh: float = 0.5,
               class_thresh: float = 0.45, decode=box_ops.ssd_decode,
               use_variance: bool = False, scale: float = 1.0,
               drop_lone_survivor: bool = False) -> NMSResult:
    """SSD / RetinaNet batched NMS.

    loc_preds [B, D, 4] offsets; cls_preds [B, D, C] logits; anchors_xywh
    [D, 4] (numpy or tensor).  :func:`anchor_candidates`, then the
    class-agnostic greedy NMS without merge in f32, with
    ``drop_lone_survivor`` as ``greedy_nms`` takes it.  ``obj`` is 0.
    """
    c = anchor_candidates(loc_preds, cls_preds, anchors_xywh, top_k,
                          class_thresh, decode, use_variance, scale)
    kept_boxes, keep = nms_kernel.greedy_nms(
        *c.nms_inputs(), nms_thresh=nms_thresh, class_aware=False,
        merge=False, plus1=1.0, drop_lone_survivor=drop_lone_survivor)
    # compared in the scores' dtype, as for the YOLO candidates
    v = keep & (c.scores > NEG_INF)
    return NMSResult(kept_boxes, torch.zeros_like(c.scores),
                     torch.where(v, c.scores, 0.0), c.labels, v)
