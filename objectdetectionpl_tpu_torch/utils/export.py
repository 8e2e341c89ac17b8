"""Serving export: the whole inference chain as one saved ``torch.export``
program.

The port of ``objectdetectionpl_tpu/utils/export.py``.  uint8 images ->
cast (the /255 folded into the stem conv where the JAX package folds it,
else divided) -> forward -> decode -> top-k -> the NMS op
(``objdet::greedy_nms``, ``ops/cuda/nms_kernel.py``), captured by
``torch.export.export`` at a static batch and size and written as a
``.pt2`` file.  :func:`load` needs only the op registration, not the model
code.

A ``.pt2`` holds the weights and tables as tensors on the device it was
exported on; :func:`load` moves the program to the device the port's rule
gives (``device.resolve_device``: the card unless the caller names
another) -- its parameters, buffers and lifted constants and the
``device=`` arguments of its nodes -- so that, like JAX's StableHLO, a
program exported on the card serves on the CPU and the other way round.
The NMS op then runs the CUDA kernel or its plain version by its inputs'
device, as it does eagerly.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from objectdetectionpl_tpu_torch.device import resolve_device

# registers objdet::greedy_nms, which a loaded program calls
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel  # noqa: F401
from objectdetectionpl_tpu_torch.utils.fuse import STEM_CONV, fold_input_scale

# the stem conv the /255 folds into: YOLOv5's Focus conv, the one path
# JAX's ``fold_input_scale`` knows by default
STEM_KEY = STEM_CONV + ".weight"


class InferenceModule(nn.Module):
    """uint8 ``[B, S, S, 3]`` -> ``(boxes, obj, scores, labels, valid)``:
    a copy of the model in eval mode with the given weights, and the
    postprocess."""

    def __init__(self, model: nn.Module, state_dict: Dict[str, torch.Tensor],
                 postprocess: Callable, fold: bool):
        super().__init__()
        self.model = copy.deepcopy(model).eval()
        if fold:
            state_dict = fold_input_scale(state_dict, 1.0 / 255.0)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.requires_grad_(False)
        self.postprocess = postprocess
        self.fold = fold

    def forward(self, raw_uint8: torch.Tensor):
        images = raw_uint8.to(self.model.dtype)
        if not self.fold:
            images = images / 255.0
        return tuple(self.postprocess(self.model(images)))


def build_inference_fn(model: nn.Module, state_dict: Dict[str, torch.Tensor],
                       postprocess: Callable,
                       fold_preproc: Optional[bool] = None) -> nn.Module:
    """The serving chain as a module: uint8 ``[B, S, S, 3]`` -> the plain
    tuple ``(boxes, obj, scores, labels, valid)``.

    ``state_dict`` is the model's full state (parameters and BN
    statistics), e.g. the EMA parameters over the module's buffers.  The
    model itself is not changed.  ``fold_preproc`` as in JAX: ``None``
    folds the /255 into the stem conv when the model has YOLOv5's stem and
    divides otherwise; ``True`` on a model without that stem raises
    ``KeyError``; ``False`` divides.
    """
    fold = STEM_KEY in state_dict if fold_preproc is None else fold_preproc
    if fold and STEM_KEY not in state_dict:
        raise KeyError(f"fold_preproc: the model has no stem conv "
                       f"{STEM_KEY!r} to fold the /255 into")
    return InferenceModule(model, state_dict, postprocess, fold)


def save(path: str, fn: nn.Module, batch: int, img_size: int) -> None:
    """``torch.export`` of the serving module at a static uint8 shape
    ``[batch, img_size, img_size, 3]`` on the module's device, written to
    ``path`` (``torch.export.save``, a ``.pt2`` archive).

    One eager call comes first: it fills the device tables the chain
    copies once (anchors, default boxes, resize matrices;
    ``device.device_table``), so the trace captures them as constants on
    the device instead of copies from the host in every call.  The
    example input is not saved (at B=64, 640 px, it would be 79 MB of
    zeros in the archive).
    """
    device = next(fn.parameters()).device
    example = torch.zeros((batch, img_size, img_size, 3), dtype=torch.uint8,
                          device=device)
    with torch.no_grad():
        fn(example)
    program = torch.export.export(fn, (example,))
    program.example_inputs = None
    torch.export.save(program, path)


def load_program(path: str, device=None) -> torch.export.ExportedProgram:
    """The program saved at ``path``, moved to ``resolve_device(device)``
    (``torch.export.passes.move_to_device_pass``)."""
    target = resolve_device(device)
    program = torch.export.load(path)
    return move_to_device_pass(program, target)


def load(path: str, device=None) -> Callable:
    """The program saved at ``path`` as a callable on
    ``resolve_device(device)``: uint8 images of the exported shape on that
    device -> the tuple of :func:`build_inference_fn`."""
    return load_program(path, device).module()
