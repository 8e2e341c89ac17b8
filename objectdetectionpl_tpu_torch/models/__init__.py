"""Detector families as torch modules over NHWC inputs.

Output contracts match the JAX package's models:

- YOLOv2: 1 raw map [B, 5*(5+C), g, g], stride 32
- YOLOv3: 3 raw maps [B, 3*(5+C), g, g], strides (32, 16, 8)
- YOLOv4: 3 raw maps [B, 3*(5+C), g, g], strides (8, 16, 32)
- YOLOv5: 3 reshaped maps [B, 3, g, g, 5+C], strides (8, 16, 32)
- SSD: (loc [B, 8732, 4], cls [B, 8732, 1+C])
- RetinaNet: (loc [B, A, 4], cls [B, A, C]), A anchors over p3..p7
"""

from objectdetectionpl_tpu_torch.models.registry import (  # noqa: F401
    MODELS, build_model, default_img_size)
