"""Serving entry points: model-family postprocess and the predict step.

The PyTorch counterparts of ``make_postprocess`` and ``make_predict_step``
in ``objectdetectionpl_tpu/train/step.py``.  The predict step runs the
model in inference mode on whatever device it lives on; the train and eval
steps come with the training slice (ROADMAP A7).
"""

from __future__ import annotations

from typing import Callable

import torch

from objectdetectionpl_tpu_torch.models.registry import NOT_PORTED
from objectdetectionpl_tpu_torch.ops import anchors as anchor_lib
from objectdetectionpl_tpu_torch.ops import nms


def make_predict_step(model: torch.nn.Module, postprocess: Callable
                      ) -> Callable:
    """Returns ``predict_step(images) -> NMSResult``: eval-mode forward on
    NHWC images (any dtype the model casts from, e.g. uint8 with the /255
    folded into the stem) + decode + batched NMS."""

    def predict_step(images: torch.Tensor) -> nms.NMSResult:
        if model.training:
            raise RuntimeError("predict_step needs the model in eval mode")
        with torch.inference_mode():
            return postprocess(model(images))

    return predict_step


def make_postprocess(model_name: str, num_classes: int, img_size: int,
                     conf_thres: float = 0.5, nms_thres: float = 0.4,
                     top_k: int = 300) -> Callable:
    """Model-family decode + NMS, emitting pixel-space boxes (YOLOv5 only).

    ``img_size`` is unused by YOLOv5, whose decode is stride-based; it is
    kept so callers pass the same arguments as to the JAX function.
    """
    if model_name in NOT_PORTED:
        raise NotImplementedError(f"{model_name} postprocess is not ported "
                                  f"yet ({NOT_PORTED[model_name]})")
    if model_name != "YOLOv5":
        raise KeyError(model_name)

    def post(outputs):
        preds = nms.decode_yolov5_predictions(
            outputs, anchor_lib.YOLOV5_ANCHORS, anchor_lib.YOLOV5_STRIDES,
            num_classes)
        return nms.yolo_nms(preds, conf_thres, nms_thres, top_k)

    return post
