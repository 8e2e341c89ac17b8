"""Model registry: string name -> module class, and default image sizes.

The PyTorch counterpart of ``objectdetectionpl_tpu/models/registry.py``.
Image-size defaults for all six families: RetinaNet 600, SSD 300, YOLOv5
640, else 416.
"""

from __future__ import annotations

import torch

from objectdetectionpl_tpu_torch.device import DeviceLike, resolve_device
from objectdetectionpl_tpu_torch.models.retinanet import RetinaNet
from objectdetectionpl_tpu_torch.models.ssd import SSD
from objectdetectionpl_tpu_torch.models.yolov2 import YOLOv2
from objectdetectionpl_tpu_torch.models.yolov3 import YOLOv3
from objectdetectionpl_tpu_torch.models.yolov4 import YOLOv4
from objectdetectionpl_tpu_torch.models.yolov5 import YOLOv5
from objectdetectionpl_tpu_torch.nn.blocks import init_weights

MODELS = {"YOLOv2": YOLOv2, "YOLOv3": YOLOv3, "YOLOv4": YOLOv4,
          "YOLOv5": YOLOv5, "SSD": SSD, "RetinaNet": RetinaNet}

DEFAULT_IMG_SIZE = {
    "YOLOv2": 416,
    "YOLOv3": 416,
    "YOLOv4": 416,
    "YOLOv5": 640,
    "SSD": 300,
    "RetinaNet": 600,
}

def default_img_size(model_name: str) -> int:
    return DEFAULT_IMG_SIZE[model_name]


def build_model(model_name: str, num_classes: int,
                dtype: torch.dtype = torch.float32,
                yolov5_type: str = "Yolov5s", remat: str = "none",
                ssd_bn: bool = False, device: DeviceLike = None,
                seed: int = 0) -> torch.nn.Module:
    """Instantiate a detector by config name, in eval mode, on ``device``.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and then moved, so one seed gives the same weights on every device;
    each conv by its family's initializer (``Conv.init``: lecun normal, and
    for SSD He/fan-out on the VGG convs, Xavier on the extras and heads).
    ``dtype`` is the compute dtype of the convolutions; parameters and BN
    statistics stay float32.  ``remat`` ("none", "early", "all": the
    activations YOLOv5 recomputes in the backward pass) and ``yolov5_type``
    are read by YOLOv5 only, ``ssd_bn`` (SSD's BN backbone) by SSD only;
    the other families ignore them, as in JAX.
    """
    dev = resolve_device(device)
    kw = ({"variant": yolov5_type, "remat": remat}
          if model_name == "YOLOv5" else
          {"use_bn": ssd_bn} if model_name == "SSD" else {})
    model = MODELS[model_name](num_classes=num_classes, dtype=dtype, **kw)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(dev)
