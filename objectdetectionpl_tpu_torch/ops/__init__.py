"""Tensor ops: boxes, anchors, YOLOv5 assignment and loss, decode and NMS,
the host mAP metrics; kernels under ``ops/cuda``."""
