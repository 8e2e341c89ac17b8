"""Plain PyTorch layers of the frozen float32 references.

Frozen copies of the building blocks the port's models use
(``nn/blocks.py``), written in plain ``torch`` with no kernel of the port:
the same submodule names, so one state dict loads into the reference and
into the port alike, and the same arithmetic, computed in float32.

``Numerics`` states the precisions: float32 throughout, or the control,
each one step below what the configurations state: the bfloat16 compute
in float8 e4m3 with a per-tensor scale, the float32 parameters, optimizer
state and augmented images in bfloat16; or the compute alone in float8
with the stored precisions float32.  Every conv rounds its input,
its weight and its output through the compute precision, and every
BatchNorm, activation and residual sum its output, as the port's bf16
layers round theirs; the products are summed in float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0          # largest finite float8 e4m3fn value


class Numerics:
    """The precisions: ``"float32"``, ``"fp8"`` (compute in float8, the
    stored tensors in bfloat16) or ``"fp8_compute"`` (compute in float8,
    the stored tensors in float32)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8", "fp8_compute"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def store(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the stored precision keeps it (parameters, optimizer
        state, images)."""
        if self.precision != "fp8":
            return t
        return t.to(torch.bfloat16).to(t.dtype)

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.precision == "float32":
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (t / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (q - t).detach()          # straight through for gradients


F32 = Numerics()


class Conv(nn.Module):
    """Conv over NCHW with an OIHW weight, padding ``(k - 1) // 2``."""

    def __init__(self, c1: int, c2: int, kernel: int = 1, stride: int = 1,
                 bias: bool = False, numerics: Numerics = F32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c2, c1, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(c2)) if bias else None
        self.stride = stride
        self.padding = (kernel - 1) // 2
        self.numerics = numerics

    def forward(self, x):
        q = self.numerics.operand
        bias = None if self.bias is None else self.bias.float()
        return q(F.conv2d(q(x), q(self.weight), bias, self.stride,
                          self.padding))


class BatchNorm(nn.Module):
    """``y = x*a + b``, ``a = scale * rsqrt(var + eps)``, ``b = bias -
    mean*a``.  Train mode: the batch's moments over (N, H, W), the biased
    variance ``E[x^2] - E[x]^2`` clamped at 0.  Eval mode: the running
    statistics.  The running statistics are not moved: nothing the
    references compare reads them."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 numerics: Numerics = F32):
        super().__init__()
        self.numerics = numerics
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps

    def forward(self, x):
        if self.training:
            mean = x.mean((0, 2, 3))
            var = torch.clamp(x.square().mean((0, 2, 3)) - mean.square(),
                              min=0.0)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        return self.numerics.operand(x * a[None, :, None, None]
                                     + b[None, :, None, None])


ACTIVATIONS = {"leaky": lambda x: F.leaky_relu(x, 0.1), "relu": F.relu,
               "linear": lambda x: x}


class ConvBN(nn.Module):
    def __init__(self, c1: int, c2: int, kernel: int = 3, stride: int = 1,
                 act: str = "leaky", numerics: Numerics = F32):
        super().__init__()
        self.Conv_0 = Conv(c1, c2, kernel, stride, numerics=numerics)
        self.BatchNorm_0 = BatchNorm(c2, numerics=numerics)
        self.act = ACTIVATIONS[act]
        self.numerics = numerics

    def forward(self, x):
        return self.numerics.operand(self.act(self.BatchNorm_0(
            self.Conv_0(x))))


def max_pool(x, window: int, stride: int, pad: int = 0):
    return F.max_pool2d(x, window, stride, pad)


def space_to_depth(x, block: int = 2):
    """[B, C, H, W] -> [B, C*b*b, H/b, W/b], channel ``(i*b + j)*C + c``."""
    B, C, H, W = x.shape
    t = x.reshape(B, C, H // block, block, W // block, block)
    return t.permute(0, 3, 5, 1, 2, 4).reshape(B, block * block * C,
                                               H // block, W // block)


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """float32 [n_in, n_out]: ``jax.image.resize``'s bilinear matrix, the
    triangle kernel widened by the downscale factor, each column divided
    by its sum, no weight for a sample outside the input."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / f32(max(inv_scale, 1.0))
    w = np.maximum(f32(0.0), f32(1.0) - dist)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x, size: Sequence[int]):
    """Bilinear resize of NCHW ``x`` to ``size`` by the two matrices."""
    H, W = x.shape[2], x.shape[3]
    wh = torch.from_numpy(resize_weights(H, size[0])).to(x.device, x.dtype)
    ww = torch.from_numpy(resize_weights(W, size[1])).to(x.device, x.dtype)
    return wh.t() @ x @ ww
