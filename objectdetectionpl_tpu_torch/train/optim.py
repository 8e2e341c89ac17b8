"""Optimizer and epoch-stepped LR schedulers: the port of ``objectdetectionpl_tpu/train/optim.py``.

Adam, the config default, is ``torch.optim.Adam`` with L2 weight decay added
to the gradient before the moments and eps 1e-8 outside the square root:
the same update as the JAX package's ``add_decayed_weights`` +
``scale_by_adam`` chain.  SGD, RMSprop and Adagrad are not ported yet
(ROADMAP A7): optax puts RMSprop's and Adagrad's eps inside the square root,
torch after it, so they need their own update rules.

The seven schedulers are plain Python, copied from the JAX package; the
host steps them once per epoch and writes the new rate with
:func:`set_learning_rate`.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

NOT_PORTED = ("SGD", "RMSprop", "Adagrad")


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """cfg needs: optimizer, lr, weight_decay, betas."""
    name = cfg.optimizer
    if name in NOT_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet "
                                  f"(ROADMAP A7)")
    if name != "Adam":
        raise ValueError(f"unknown optimizer {name!r}")
    b1, b2 = cfg.betas
    return torch.optim.Adam(params, lr=cfg.lr, betas=(b1, b2), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float
                      ) -> torch.optim.Optimizer:
    """Rewrite the learning rate of every parameter group (host scheduler)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class Scheduler:
    """Epoch-stepped LR scheduler. ``step(metric)`` returns the new LR."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.epoch = -1

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        return self._lr(metric)

    def _lr(self, metric):
        raise NotImplementedError


class ConstantLR(Scheduler):
    """LambdaLR with a constant lambda."""

    def _lr(self, metric):
        return self.base_lr


class StepLR(Scheduler):
    def __init__(self, base_lr, step_size=3, gamma=0.8):
        super().__init__(base_lr)
        self.step_size, self.gamma = step_size, gamma

    def _lr(self, metric):
        return self.base_lr * self.gamma ** (self.epoch // self.step_size)


class MultiStepLR(Scheduler):
    def __init__(self, base_lr, milestones=(70, 140, 190), gamma=0.1):
        super().__init__(base_lr)
        self.milestones, self.gamma = milestones, gamma

    def _lr(self, metric):
        k = sum(1 for m in self.milestones if self.epoch >= m)
        return self.base_lr * self.gamma ** k


class ExponentialLR(Scheduler):
    def __init__(self, base_lr, gamma=0.99):
        super().__init__(base_lr)
        self.gamma = gamma

    def _lr(self, metric):
        return self.base_lr * self.gamma ** self.epoch


class CosineAnnealingLR(Scheduler):
    def __init__(self, base_lr, t_max=20, eta_min=0.0):
        super().__init__(base_lr)
        self.t_max, self.eta_min = t_max, eta_min

    def _lr(self, metric):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.epoch / self.t_max)) / 2)


class CyclicLR(Scheduler):
    """Triangular cycle 1e-5 .. 0.1 (torch's step_size_up=2000, stepped per
    epoch, so in practice a slow linear ramp)."""

    def __init__(self, base_lr, low=1e-5, high=0.1, step_size=2000):
        super().__init__(base_lr)
        self.low, self.high, self.step_size = low, high, step_size

    def _lr(self, metric):
        cycle = math.floor(1 + self.epoch / (2 * self.step_size))
        x = abs(self.epoch / self.step_size - 2 * cycle + 1)
        return self.low + (self.high - self.low) * max(0.0, 1 - x)


class ReduceLROnPlateau(Scheduler):
    """torch semantics with the reference's arguments: mode='max', patience
    3, threshold 0.9 (rel), factor 0.1, monitoring val_loss.  The reference
    monitors a *loss* in 'max' mode; kept, and ``mode`` can change it."""

    def __init__(self, base_lr, mode="max", factor=0.1, patience=3,
                 threshold=0.9, min_lr=0.0):
        super().__init__(base_lr)
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.min_lr = threshold, min_lr
        self.best = None
        self.bad_epochs = 0
        self.lr = base_lr

    def _improved(self, metric):
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1 + self.threshold)
        return metric < self.best * (1 - self.threshold)

    def _lr(self, metric):
        if metric is None:
            return self.lr
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


def build_scheduler(cfg) -> Scheduler:
    name = cfg.lr_scheduler
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(cfg.lr, patience=cfg.patience,
                                 threshold=cfg.threshold)
    if name == "StepLR":
        return StepLR(cfg.lr)
    if name == "MultiStepLR":
        return MultiStepLR(cfg.lr)
    if name == "ExponentialLR":
        return ExponentialLR(cfg.lr)
    if name == "CosineAnnealingLR":
        return CosineAnnealingLR(cfg.lr)
    if name == "LambdaLR":
        return ConstantLR(cfg.lr)
    if name == "CyclicLR":
        return CyclicLR(cfg.lr)
    raise ValueError(f"unknown scheduler {name!r}")
