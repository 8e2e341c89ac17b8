"""Box panels for the metric writer: the port of ``objectdetectionpl_tpu/utils/viz.py``.

Drawn in numpy (the port imports no PIL): 2 px outlines in the palette's
colours, as PIL's ``rectangle(..., width=2)`` draws them (corners truncated
to integers, the outline inside the box, clipped to the image).  The
class-name text of the JAX panels is dropped (ROADMAP §C).
:func:`write_png` saves a panel with the standard library alone.
"""

from __future__ import annotations

import struct
import zlib

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


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """uint8 [H, W, 3] -> an 8-bit RGB PNG (filter 0 on every row)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [H, W, 3], got {rgb.dtype} "
                         f"{rgb.shape}")
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
