"""Train, eval and predict steps.

The PyTorch counterparts of ``make_train_step``, ``make_eval_step``,
``make_predict_step`` and ``make_postprocess`` in
``objectdetectionpl_tpu/train/step.py``.  PyTorch runs eagerly, so a step is
a plain function over the model and optimizer it closes over; it updates
them in place and returns tensors, with no host sync inside.

Train batches are ``[A, mB, ...]`` (A microbatches of mB images), as in the
JAX package.  Under a process group a train step is the global batch's:
each rank's ``[A, mB, ...]`` holds its rows of the global microbatches,
the losses carry the global normalisers (``ops/losses.py``), one
coalesced all-reduce sums the gradients before the optimizer, and the
metrics returned are the global ones.  The eval and predict steps run no
collective.
"""

from __future__ import annotations

from typing import Callable

import torch

from objectdetectionpl_tpu_torch.device import device_table
from objectdetectionpl_tpu_torch.ops import anchors as anchor_lib
from objectdetectionpl_tpu_torch.ops import boxes as box_ops
from objectdetectionpl_tpu_torch.ops import nms
from objectdetectionpl_tpu_torch.parallel import distributed
from objectdetectionpl_tpu_torch.train.state import TrainState


def make_train_step(model: torch.nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer, accum_steps: int = 1,
                    ema_decay: float = 0.0) -> Callable:
    """Returns ``train_step(state, images, labels, boxes, mask, weights=None)
    -> (state, metrics)``.

    images [A, mB, S, S, 3]; labels/boxes/mask [A, mB, ...]; ``weights`` [A]
    is each microbatch's share (0 marks a padding microbatch that flushes a
    partial accumulation window).  The model runs in train mode.  Gradients
    are ``sum(w * g) / max(sum(w), 1)`` over microbatches and metrics are
    averaged the same way; the BN running statistics carry from microbatch
    to microbatch, and a zero-weight microbatch leaves them as they were.
    The optimizer updates the parameters, then the EMA copy (if the state
    has one and ``ema_decay > 0``) moves as ``e*decay + p*(1-decay)``.

    Under a process group every rank calls the step on its shard with the
    same ``weights``; the gradients and metrics are summed over the ranks
    (each rank's loss is its share of the global batch's, so no 1/R).
    """
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    stats = list(model.buffers())

    def grads_of(images, labels, boxes, mask):
        for p in params:
            p.grad = None
        with distributed.global_batch():
            metrics = loss_fn(model(images), labels, boxes, mask)
            metrics["loss"].backward()
        grads = [p.grad for p in params]
        return {k: v.detach() for k, v in metrics.items()}, grads

    def apply_update(state, grads, metrics):
        distributed.all_reduce_(grads)
        if distributed.data_shard()[0] > 1:
            keys = list(metrics)
            total = torch.stack([metrics[k].float() for k in keys])
            distributed.all_reduce_([total])
            metrics = {k: total[i].to(metrics[k].dtype)
                       for i, k in enumerate(keys)}
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        if state.ema_params is not None and ema_decay > 0:
            with torch.no_grad():
                ema = [state.ema_params[n] for n, _ in named]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul(
                    [p.detach() for p in params], 1.0 - ema_decay))
        state.step += 1
        return state, metrics

    def train_step(state: TrainState, images, labels, boxes, mask,
                   weights=None):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("train_step: the state holds another model or "
                             "optimizer than the step was made for")
        model.train()
        if accum_steps == 1 and weights is None:
            metrics, grads = grads_of(images[0], labels[0], boxes[0],
                                      mask[0])
            return apply_update(state, grads, metrics)

        A = images.shape[0]
        w = (torch.ones(A, device=images.device) if weights is None else
             torch.as_tensor(weights, dtype=torch.float32,
                             device=images.device))
        acc, per_micro = None, []
        for i in range(A):
            before = [b.clone() for b in stats]
            metrics, grads = grads_of(images[i], labels[i], boxes[i],
                                      mask[i])
            acc = ([g * w[i] for g in grads] if acc is None else
                   [a + g * w[i] for a, g in zip(acc, grads)])
            with torch.no_grad():
                for b, old in zip(stats, before):
                    b.copy_(torch.where(w[i] > 0, b, old))
            per_micro.append(metrics)
        wsum = w.sum().clamp(min=1.0)
        grads = [a / wsum for a in acc]
        metrics = {k: (torch.stack([m[k] for m in per_micro]) * w).sum()
                   / wsum for k in per_micro[0]}
        return apply_update(state, grads, metrics)

    return train_step


def make_eval_step(model: torch.nn.Module, loss_fn: Callable) -> Callable:
    """Returns ``eval_step(state, images, labels, boxes, mask) -> metrics``:
    the loss of an eval-mode forward (running statistics) with the state's
    ``eval_params`` (EMA when enabled), without gradients.  The model's
    mode is restored afterwards."""

    def eval_step(state: TrainState, images, labels, boxes, mask):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                out = torch.func.functional_call(model, state.eval_params,
                                                 (images,))
                return loss_fn(out, labels, boxes, mask)
        finally:
            model.train(was_training)

    return eval_step


def make_predict_step(model: torch.nn.Module, postprocess: Callable
                      ) -> Callable:
    """Returns ``predict_step(state, images) -> NMSResult``: an eval-mode
    forward with the state's ``eval_params`` (EMA when enabled) on NHWC
    images (any dtype the model casts from, e.g. uint8 with the /255 folded
    into the stem) + decode + batched NMS.  Without an EMA the module runs
    with its own parameters, called directly."""

    def predict_step(state: TrainState, images: torch.Tensor
                     ) -> nms.NMSResult:
        if state.model is not model:
            raise ValueError("predict_step: the state holds another model "
                             "than the step was made for")
        if model.training:
            raise RuntimeError("predict_step needs the model in eval mode")
        with torch.inference_mode():
            if state.ema_params is None:
                return postprocess(model(images))
            return postprocess(torch.func.functional_call(
                model, state.ema_params, (images,)))

    return predict_step


# (anchors in input pixels per output map, strides) of the YOLOv2/v3/v4
# decodes.  YOLOv2's anchors are output-grid units: x 32 at stride 32,
# whatever the input size.
YOLO_DECODE = {
    "YOLOv2": ([anchor_lib.YOLOV2_ANCHORS * 32], (32,)),
    "YOLOv3": (anchor_lib.YOLOV3_ANCHORS, anchor_lib.YOLOV3_STRIDES),
    "YOLOv4": ([anchor_lib.YOLOV4_ANCHORS[list(m)]
                for m in anchor_lib.YOLOV4_ANCH_MASKS],
               anchor_lib.YOLOV4_STRIDES),
}


def _on_device(table) -> Callable:
    """``device -> table`` as f32 on that device, copied there on the first
    eager call only (``device.device_table``: a trace never fills it)."""
    on_device = {}

    def get(dev):
        return device_table(on_device, dev, lambda: torch.as_tensor(
            table, dtype=torch.float32, device=dev))
    return get


def make_postprocess(model_name: str, num_classes: int, img_size: int,
                     conf_thres: float = 0.5, nms_thres: float = 0.4,
                     top_k: int = 300) -> Callable:
    """Family-specific decode + NMS, emitting pixel-space boxes.

    SSD and RetinaNet: anchor decode + class-agnostic greedy NMS
    (``nms.anchor_nms``: IoU 0.5, its own top-k of 100, class threshold
    ``min(0.45, conf_thres)``); SSD drops the background channel and
    scales its normalized boxes by ``img_size``.  YOLO: family decode +
    weighted-merge NMS (``nms_thres``, ``top_k``); their decodes are
    stride-based and ignore ``img_size``.
    """
    # the anchor families' class threshold is 0.45 unless the configured
    # conf_thres is lower (an untrained model's scores may all lie below it)
    anchor_class_thresh = min(0.45, conf_thres)
    if model_name == "SSD":
        dboxes = _on_device(anchor_lib.ssd_dboxes())

        def post(outputs):
            loc, cls = outputs
            return nms.anchor_nms(loc, cls[..., 1:], dboxes(loc.device),
                                  nms_thresh=0.5,
                                  class_thresh=anchor_class_thresh,
                                  scale=float(img_size))
        return post

    if model_name == "RetinaNet":
        anchors = _on_device(anchor_lib.retina_anchors(img_size))

        def post(outputs):
            loc, cls = outputs
            return nms.anchor_nms(loc, cls, anchors(loc.device),
                                  decode=box_ops.retina_decode,
                                  nms_thresh=0.5,
                                  class_thresh=anchor_class_thresh,
                                  scale=1.0)
        return post

    if model_name == "YOLOv5":
        def post(outputs):
            preds = nms.decode_yolov5_predictions(
                outputs, anchor_lib.YOLOV5_ANCHORS,
                anchor_lib.YOLOV5_STRIDES, num_classes)
            return nms.yolo_nms(preds, conf_thres, nms_thres, top_k)
        return post

    anchors_px, strides = YOLO_DECODE[model_name]

    def post(outputs):
        if not isinstance(outputs, (list, tuple)):
            outputs = [outputs]
        preds = nms.decode_yolo_predictions(outputs, anchors_px, strides,
                                            num_classes)
        return nms.yolo_nms(preds, conf_thres, nms_thres, top_k)

    return post
