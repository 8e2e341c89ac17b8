"""Adam with L2 weight decay added to the gradient, in plain float32
PyTorch: the update the configurations state (``optimizer`` section) and
the port runs as ``torch.optim.Adam``."""

from __future__ import annotations

import math

import torch


class Adam:
    """``g' = g + wd p; m = b1 m + (1 - b1) g'; v = b2 v + (1 - b2) g'^2;
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``."""

    def __init__(self, params, cfg: dict, store=lambda t: t):
        self.params = list(params)
        self.store = store          # the precision the state is kept in
        self.lr, self.wd, self.eps = cfg["lr"], cfg["weight_decay"], cfg["eps"]
        self.b1, self.b2 = cfg["betas"]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0
        self.first_grads = None      # g' of the first step, per parameter

    @torch.no_grad()
    def step(self):
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        grads = []
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad + self.wd * p
            grads.append(g.clone())
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / math.sqrt(bc2) + self.eps))
            for t in (p, m, v):
                t.copy_(self.store(t))
        if self.first_grads is None:
            self.first_grads = grads
