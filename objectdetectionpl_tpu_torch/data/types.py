"""Shared data types for the loading pipeline: the port's copy of
``objectdetectionpl_tpu/data/types.py``."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class Example(NamedTuple):
    """One parsed example, host-side, pre-resize.

    image: uint8 [H, W, 3] RGB.
    boxes: float32 [N, 4] top-left pixel xywh (parser-native, converted to
           normalized center form by the pipeline).
    labels: int32 [N] 0-based class ids.
    """

    image: np.ndarray
    boxes: np.ndarray
    labels: np.ndarray


class Batch(NamedTuple):
    """Fixed-shape host batch; the Trainer moves it to the device.

    images: float32 [B, S, S, 3] in [0, 1], RGB, NHWC.
    labels: int32 [B, M].
    boxes:  float32 [B, M, 4] center-form xywh normalized to [0, 1].
    mask:   bool [B, M].
    """

    images: np.ndarray
    labels: np.ndarray
    boxes: np.ndarray
    mask: np.ndarray


def pad_targets(boxes_list: Sequence[np.ndarray],
                labels_list: Sequence[np.ndarray], max_boxes: int):
    """Ragged per-image targets -> padded [B, M] arrays (extra boxes dropped)."""
    B = len(boxes_list)
    boxes = np.zeros((B, max_boxes, 4), np.float32)
    labels = np.zeros((B, max_boxes), np.int32)
    mask = np.zeros((B, max_boxes), bool)
    for i, (bx, lb) in enumerate(zip(boxes_list, labels_list)):
        n = min(len(lb), max_boxes)
        if n:
            boxes[i, :n] = bx[:n]
            labels[i, :n] = lb[:n]
            mask[i, :n] = True
    return boxes, labels, mask


def topleft_to_center_norm(boxes_px: np.ndarray, w: int, h: int) -> np.ndarray:
    """Top-left pixel xywh -> normalized center xywh."""
    out = boxes_px.astype(np.float32).copy()
    if out.size == 0:
        return out.reshape(-1, 4)
    out[:, 0] = (boxes_px[:, 0] + boxes_px[:, 2] / 2) / w
    out[:, 1] = (boxes_px[:, 1] + boxes_px[:, 3] / 2) / h
    out[:, 2] = boxes_px[:, 2] / w
    out[:, 3] = boxes_px[:, 3] / h
    return out
