"""YOLOv5 anchor table, strides and grid offsets (host-side numpy constants).

The port's copy of the YOLOv5 part of ``objectdetectionpl_tpu/ops/anchors.py``.
The other families' tables come with their slices.
"""

from __future__ import annotations

import numpy as np

# 3 scales x 3 anchors, input-pixel units; strides 8/16/32.
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
