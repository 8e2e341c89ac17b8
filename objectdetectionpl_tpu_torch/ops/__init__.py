"""Tensor ops: boxes, anchors, YOLOv5 assignment and loss, decode and NMS;
kernels under ``ops/cuda``."""
