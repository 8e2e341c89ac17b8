"""Anchor tables, default boxes and grid offsets (host-side numpy constants).

The port's copy of ``objectdetectionpl_tpu/ops/anchors.py``: the YOLO
anchor tables and strides, the SSD-300 default boxes and the RetinaNet
anchors over p3..p7.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

# YOLOv2: 5 anchors in output-grid units (13x13 at 416 px).
YOLOV2_ANCHORS = np.array(
    [[1.3221, 1.73145], [3.19275, 4.00944], [5.05587, 8.09892],
     [9.47112, 4.84053], [11.2364, 10.0071]], dtype=np.float32)

# YOLOv3: 3 scales x 3 anchors, input-pixel units, in output order.
YOLOV3_ANCHORS = np.array(
    [[[116, 90], [156, 198], [373, 326]],   # stride 32
     [[30, 61], [62, 45], [59, 119]],       # stride 16
     [[10, 13], [16, 30], [33, 23]]],       # stride 8
    dtype=np.float32)
YOLOV3_STRIDES = (32, 16, 8)

# YOLOv4: flat 9-anchor table (input pixels) + per-scale masks.
YOLOV4_ANCHORS = np.array(
    [[12, 16], [19, 36], [40, 28], [36, 75], [76, 55],
     [72, 146], [142, 110], [192, 243], [459, 401]], dtype=np.float32)
YOLOV4_ANCH_MASKS = ((0, 1, 2), (3, 4, 5), (6, 7, 8))
YOLOV4_STRIDES = (8, 16, 32)

# YOLOv5: 3 scales x 3 anchors, input-pixel units; strides 8/16/32.
YOLOV5_ANCHORS = np.array(
    [[[10, 13], [16, 30], [33, 23]],        # stride 8
     [[30, 61], [62, 45], [59, 119]],       # stride 16
     [[116, 90], [156, 198], [373, 326]]],  # stride 32
    dtype=np.float32)
YOLOV5_STRIDES = (8, 16, 32)


def yolo_grid(grid_size: int) -> np.ndarray:
    """Per-cell (x, y) integer offsets, shape [g, g, 2] with x varying fastest."""
    g = grid_size
    xs = np.tile(np.arange(g, dtype=np.float32)[None, :], (g, 1))
    ys = np.tile(np.arange(g, dtype=np.float32)[:, None], (1, g))
    return np.stack([xs, ys], axis=-1)


def scale_anchors(anchors_px: np.ndarray, stride: float) -> np.ndarray:
    """Input-pixel anchors -> grid units."""
    return np.asarray(anchors_px, dtype=np.float32) / float(stride)


# --- SSD default boxes -----------------------------------------------------


def ssd_dboxes(smin: float = 0.07, smax: float = 0.9,
               ars=(1, 2, 0.5, 3, 1 / 3.0),
               fks=(38, 19, 10, 5, 3, 1),
               num_boxes=(3, 5, 5, 5, 3, 3)) -> np.ndarray:
    """SSD-300 default boxes [8732, 4], center-form normalized, clipped to
    1.0.  Per cell: one geometric-mean box, then ``num_boxes[k]`` boxes of
    the aspect ratios ``ars``; cells column-major (i over x outermost)."""
    m = len(fks)
    sks = [round(smin + ((smax - smin) / (m - 1)) * (k - 1), 2)
           for k in range(1, m + 1)]
    boxes = []
    for k, feat_k in enumerate(fks):
        for i, j in itertools.product(range(feat_k), range(feat_k)):
            cx = (i + 0.5) / feat_k
            cy = (j + 0.5) / feat_k
            w = h = math.sqrt(sks[k] * sks[min(k + 1, m - 1)])
            boxes.append([cx, cy, w, h])
            sk = sks[k]
            for ar in ars[: num_boxes[k]]:
                boxes.append([cx, cy, sk * math.sqrt(ar), sk / math.sqrt(ar)])
    return np.minimum(np.asarray(boxes, dtype=np.float32), 1.0)


# --- RetinaNet anchors -----------------------------------------------------


def retina_anchor_wh(anchor_areas=(32 * 32.0, 64 * 64.0, 128 * 128.0,
                                   256 * 256.0, 512 * 512.0),
                     aspect_ratios=(0.5, 1.0, 2.0),
                     scale_ratios=(1.0, 2 ** (1 / 3.0), 2 ** (2 / 3.0))
                     ) -> np.ndarray:
    """[levels, 9, 2] anchor widths and heights in input pixels."""
    wh = []
    for s in anchor_areas:
        for ar in aspect_ratios:
            h = math.sqrt(s / ar)
            w = ar * h
            for sr in scale_ratios:
                wh.append([w * sr, h * sr])
    return np.asarray(wh, dtype=np.float32).reshape(len(anchor_areas), -1, 2)


def retina_anchors(input_size: int) -> np.ndarray:
    """All anchors over p3..p7 as center-form (x, y, w, h) in input pixels,
    row-major over (y, x, anchor) per level, cell centres at (i + 0.5) *
    input_size / ceil(input_size / stride)."""
    wh_table = retina_anchor_wh()
    out = []
    for i in range(wh_table.shape[0]):
        fm = math.ceil(input_size / 2 ** (i + 3))
        grid = input_size / fm
        xs = np.tile(np.arange(fm, dtype=np.float32)[None, :], (fm, 1))
        ys = np.tile(np.arange(fm, dtype=np.float32)[:, None], (1, fm))
        xy = (np.stack([xs, ys], axis=-1) + 0.5) * grid          # [fm, fm, 2]
        xy = np.broadcast_to(xy[:, :, None, :], (fm, fm, 9, 2))
        wh = np.broadcast_to(wh_table[i][None, None], (fm, fm, 9, 2))
        out.append(np.concatenate([xy, wh], axis=-1).reshape(-1, 4))
    return np.concatenate(out, axis=0)
