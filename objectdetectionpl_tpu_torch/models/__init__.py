"""Detector families as torch modules over NHWC inputs.

Output contracts match the JAX package's models; so far:

- YOLOv5: 3 reshaped maps [B, 3, g, g, 5+C], strides (8, 16, 32)
"""

from objectdetectionpl_tpu_torch.models.registry import (  # noqa: F401
    MODELS, build_model, default_img_size)
