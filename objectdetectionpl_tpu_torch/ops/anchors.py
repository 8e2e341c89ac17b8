"""YOLO anchor tables, strides and grid offsets (host-side numpy constants).

The port's copy of the YOLO part of ``objectdetectionpl_tpu/ops/anchors.py``.
The SSD default boxes and RetinaNet anchors come with their slices.
"""

from __future__ import annotations

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
