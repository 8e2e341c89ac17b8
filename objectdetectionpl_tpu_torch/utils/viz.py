"""Box panels for the metric writer: the port of ``objectdetectionpl_tpu/utils/viz.py``.

Drawn in numpy (the port imports no PIL): 2 px outlines in the palette's
colours, as PIL's ``rectangle(..., width=2)`` draws them (corners truncated
to integers, the outline inside the box, clipped to the image).  The
class-name text of the JAX panels is dropped (ROADMAP §C).
"""

from __future__ import annotations

import numpy as np

from objectdetectionpl_tpu_torch.data.palette import COLORS

WIDTH = 2                       # outline width in pixels


def _outline(img: np.ndarray, box, color) -> None:
    H, W = img.shape[:2]
    x1, y1, x2, y2 = (int(v) for v in box)
    for k in range(WIDTH):
        a, b, c, d = x1 + k, y1 + k, x2 - k, y2 - k
        if a > c or b > d:
            break
        xs = slice(max(a, 0), max(min(c, W - 1) + 1, 0))
        ys = slice(max(b, 0), max(min(d, H - 1) + 1, 0))
        for y in (b, d):
            if 0 <= y < H:
                img[y, xs] = color
        for x in (a, c):
            if 0 <= x < W:
                img[ys, x] = color


def draw_boxes(image01: np.ndarray, boxes_xyxy: np.ndarray,
               labels: np.ndarray, valid=None) -> np.ndarray:
    """image01: float [S,S,3] in [0,1]; boxes in pixel xyxy. Returns uint8."""
    img = (np.clip(image01, 0, 1) * 255).astype(np.uint8)
    for i, box in enumerate(boxes_xyxy):
        if valid is not None and not valid[i]:
            continue
        _outline(img, box, COLORS[int(labels[i]) % len(COLORS)])
    return img


def side_by_side(gt_img: np.ndarray, pred_img: np.ndarray) -> np.ndarray:
    """GT | prediction panel."""
    h = max(gt_img.shape[0], pred_img.shape[0])
    pad = lambda im: np.pad(im, ((0, h - im.shape[0]), (0, 0), (0, 0)))
    return np.concatenate([pad(gt_img), pad(pred_img)], axis=1)
