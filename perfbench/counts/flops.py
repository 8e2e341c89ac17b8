"""Floating-point operations of a configuration's model, counted by
``torch.utils.flop_counter`` on the frozen reference (not on the port),
on the meta device at batch 1.

A multiply-add counts two.  The forward counts the convolutions and
matrix products; the training count adds the backward of the same (the
gradients of the inputs and of the weights), and leaves out any
recomputation, the loss and the optimizer.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def _model(reference, cfg: dict, train: bool):
    with torch.device("meta"):
        model = reference.build(cfg)
    return model.train(train)


def _input(cfg: dict) -> torch.Tensor:
    s = cfg["model"]["img_size"]
    return torch.zeros(1, s, s, 3, device="meta")


def forward_flops(reference, cfg: dict) -> float:
    """Forward FLOPs of one image (eval mode)."""
    model = _model(reference, cfg, train=False)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(_input(cfg))
    return float(counter.get_total_flops())


def train_flops(reference, cfg: dict) -> float:
    """Forward and backward FLOPs of one image (train mode)."""
    model = _model(reference, cfg, train=True)
    with FlopCounterMode(display=False) as counter:
        out = model(_input(cfg))
        sum(o.sum() for o in out).backward()
    return float(counter.get_total_flops())


def conv_flops(reference, cfg: dict) -> float:
    """Forward FLOPs of one image from the conv layers' shapes alone:
    ``2 Cin Cout k k Ho Wo`` a convolution, read by forward hooks."""
    model = _model(reference, cfg, train=False)
    total = []

    def hook(mod, inputs, out):
        total.append(2.0 * mod.weight[0].numel() * out.shape[1]
                     * out.shape[2] * out.shape[3])

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Module) and type(m).__name__ == "Conv"]
    try:
        with torch.no_grad():
            model(_input(cfg))
    finally:
        for h in hooks:
            h.remove()
    return sum(total)
