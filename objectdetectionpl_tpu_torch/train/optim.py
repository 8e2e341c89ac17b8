"""Optimizer and epoch-stepped LR schedulers: the port of ``objectdetectionpl_tpu/train/optim.py``.

Each optimizer computes the update of the JAX package's optax chain
(optax 0.2.6): L2 weight decay ``g + wd*p`` added to the gradient first
(``add_decayed_weights``), then

- Adam: ``torch.optim.Adam``, eps 1e-8 outside the square root, as
  ``scale_by_adam``;
- SGD: ``torch.optim.SGD`` with ``dampening=0``: its momentum buffer is
  ``optax.trace`` (``m = momentum*m + g``, m0 = 0, no Nesterov);
- RMSprop (:class:`RMSprop`): ``nu = (1-alpha)*g^2 + alpha*nu``, ``u =
  g * rsqrt(nu + 1e-8)``, eps inside the root (``scale_by_rms``), then the
  momentum trace;
- Adagrad (:class:`Adagrad`): ``s = s + g^2``, ``u = where(s > 0, g *
  rsqrt(s + 1e-7), 0)`` (``scale_by_rss`` from 0), times ``1/(1 +
  t*lr_decay)`` for t completed steps.

torch's own RMSprop and Adagrad put eps outside the root, so they are not
the same update.  Every optimizer ends with ``p = p - lr*u``.

The seven schedulers are plain Python, copied from the JAX package; the
host steps them once per epoch and writes the new rate with
:func:`set_learning_rate`.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch


class _Chain(torch.optim.Optimizer):
    """The shared head and tail of the optax chains: the gradients with
    weight decay added, and ``p = p - lr*u``.  Subclasses create each
    parameter's state on its first step (:meth:`_init_state`) and compute
    ``u`` from the gradients (:meth:`_updates`)."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            # each product rounded before its sum, as optax computes it
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, torch._foreach_mul(
                    params, group["weight_decay"]))
            for p in params:
                st = self.state[p]
                if not st:
                    st.update(self._init_state(p, group))
            updates = self._updates(group, params, grads)
            torch._foreach_add_(params, torch._foreach_mul(updates,
                                                           -group["lr"]))
        return loss

    def _init_state(self, p, group) -> dict:
        raise NotImplementedError

    def _updates(self, group, params, grads):
        raise NotImplementedError


class RMSprop(_Chain):
    """optax's ``scale_by_rms(decay=alpha, eps=1e-8)`` (eps inside the
    root, nu0 = 0), then ``trace(momentum)`` when momentum is set."""

    def __init__(self, params, lr: float, alpha: float = 0.95,
                 eps: float = 1e-8, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      momentum=momentum,
                                      weight_decay=weight_decay))

    def _init_state(self, p, group) -> dict:
        keys = ("square_avg", "momentum_buffer") if group["momentum"] else \
            ("square_avg",)
        return {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                for k in keys}

    def _updates(self, group, params, grads):
        alpha, momentum = group["alpha"], group["momentum"]
        nus = [self.state[p]["square_avg"] for p in params]
        torch._foreach_mul_(nus, alpha)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - alpha)
        torch._foreach_add_(nus, g2)
        scale = torch._foreach_add(nus, group["eps"])
        torch._foreach_rsqrt_(scale)
        updates = torch._foreach_mul(grads, scale)
        if not momentum:
            return updates
        bufs = [self.state[p]["momentum_buffer"] for p in params]
        torch._foreach_mul_(bufs, momentum)
        torch._foreach_add_(bufs, updates)
        return bufs


class Adagrad(_Chain):
    """optax's ``scale_by_rss(initial_accumulator_value=0, eps=1e-7)``:
    the scale is 0 wherever the sum of squares is 0; with ``lr_decay``,
    times ``1/(1 + t*lr_decay)`` in float32, t the steps completed before
    this one (the JAX package's ``_scale_by_lr_decay``).  The ``where`` is
    a product with ``sign(s)``, equal for every sum >= 0; a NaN sum (from
    a NaN gradient, which has made the parameter NaN already) scales by
    NaN here and by 0 in optax."""

    def __init__(self, params, lr: float, lr_decay: float = 0.0,
                 eps: float = 1e-7, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, lr_decay=lr_decay, eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, p, group) -> dict:
        # the step count stays on the host, as torch's optimizers keep it
        return {"sum": torch.zeros_like(p,
                                        memory_format=torch.preserve_format),
                "step": torch.zeros((), dtype=torch.float32)}

    def _updates(self, group, params, grads):
        sums = [self.state[p]["sum"] for p in params]
        torch._foreach_add_(sums, torch._foreach_mul(grads, grads))
        # where(s > 0, rsqrt(s + eps), 0) for sums >= 0: sign(s) is 1
        # where s > 0 and 0 where it is 0
        scale = torch._foreach_add(sums, group["eps"])
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, torch._foreach_sign(sums))
        updates = torch._foreach_mul(grads, scale)
        steps = [self.state[p]["step"] for p in params]
        if group["lr_decay"]:
            # one count for the group: every parameter steps together
            factor = float(np.float32(1.0) / (
                np.float32(1.0) + np.float32(steps[0].item())
                * np.float32(group["lr_decay"])))
            torch._foreach_mul_(updates, factor)
        torch._foreach_add_(steps, 1.0)
        return updates


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """cfg needs: optimizer, lr, weight_decay, betas, momentum, alpha,
    lr_decay."""
    name, lr, wd = cfg.optimizer, cfg.lr, cfg.weight_decay
    if name == "Adam":
        b1, b2 = cfg.betas
        return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8,
                                weight_decay=wd)
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum,
                               dampening=0.0, weight_decay=wd,
                               nesterov=False)
    if name == "RMSprop":
        return RMSprop(params, lr=lr, alpha=cfg.alpha,
                       momentum=cfg.momentum, weight_decay=wd)
    if name == "Adagrad":
        return Adagrad(params, lr=lr, lr_decay=cfg.lr_decay, weight_decay=wd)
    raise ValueError(f"unknown optimizer {name!r}")


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
