"""Tensor ops: boxes, anchors, decode and NMS; kernels under ``ops/cuda``."""
