"""PyTorch counterparts of the YOLO blocks of ``objectdetectionpl_tpu/nn/blocks.py``.

Inside the model the tensors are NCHW (``channels_last`` storage when the
input came from an NHWC tensor), so these blocks take and return NCHW.
Submodules carry the flax auto-names (``ConvBN_0``, ``Conv_1``,
``BatchNorm_0``, ...) so a state_dict key is the flax variable path joined by
dots (``utils/weights.py``).

Numerics follow the JAX blocks:

- parameters and BN statistics are float32; convolutions cast input and
  kernel to the ``dtype`` knob and compute in it (flax ``nn.Conv(dtype=...)``),
- BN folds into one per-channel affine computed in f32 and cast once to the
  activation dtype, with running statistics in eval mode and f32-accumulated
  batch moments in train mode,
- padding is the explicit torch-style ``dilation * (k - 1) // 2`` unless a
  conv names its own (SSD's VALID convs: 0); max-pool pads with -inf,
- space-to-depth orders channel blocks (row-phase, col-phase, C),
- mish is ``F.mish``: ``x * tanh(softplus(x))`` in one kernel, within f32
  rounding of the JAX formula (``tests/test_torch_port_yolo_models.py``).

:func:`remat` runs a block under activation checkpointing (flax
``nn.remat``): its forward is run again in the backward pass, and train-mode
BatchNorm moves its running statistics only in the first run, so they move
once per forward as in JAX's functional state.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from objectdetectionpl_tpu_torch.device import device_table
from objectdetectionpl_tpu_torch.parallel import distributed

ACTIVATIONS = {
    "leaky": functools.partial(F.leaky_relu, negative_slope=0.1),
    "relu": F.relu,
    "mish": F.mish,
    "linear": lambda x: x,
}

# flax's truncated-normal initializers draw from a normal cut at 2 stddev,
# rescaled so the truncated distribution keeps the variance asked for.
_TRUNC_STD = 0.87962566103423978

# kernel initializers by name: (scale, fan mode, distribution), as flax's
# ``variance_scaling`` takes them
KERNEL_INITS = {
    "lecun_normal": (1.0, "fan_in", "truncated_normal"),
    "xavier_normal": (1.0, "fan_avg", "truncated_normal"),
    "kaiming_fan_out": (2.0, "fan_out", "normal"),
}


# set while a checkpointed block's forward runs again in the backward pass
# (which runs in autograd's device thread on CUDA, hence per thread)
_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    before = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = before


def remat(block: nn.Module, *args):
    """``block(*args)``, its activations recomputed in the backward pass
    instead of kept (``torch.utils.checkpoint``, non-reentrant).  The
    recomputation leaves BatchNorm's running statistics as the first run
    moved them.  No block draws random numbers, so no RNG state is kept."""
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


class Conv(nn.Module):
    """flax ``nn.Conv`` over NCHW: OIHW f32 weight, symmetric padding
    (``dilation * (k - 1) // 2`` unless ``padding`` is given), computed in
    ``dtype``.  ``init`` names the kernel initializer (``KERNEL_INITS``)
    that :func:`init_weights` applies."""

    def __init__(self, c1: int, c2: int, kernel: int = 1, stride: int = 1,
                 bias: bool = False, dtype: torch.dtype = torch.float32,
                 dilation: int = 1, padding: int = None,
                 init: str = "lecun_normal"):
        super().__init__()
        if init not in KERNEL_INITS:
            raise ValueError(f"init={init!r}: expected one of "
                             f"{sorted(KERNEL_INITS)}")
        self.weight = nn.Parameter(torch.empty(c2, c1, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(c2)) if bias else None
        self.stride = stride
        self.dilation = dilation
        self.padding = (dilation * (kernel - 1) // 2 if padding is None
                        else padding)
        self.dtype = dtype
        self.init = init

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, self.padding, self.dilation)


class BatchNorm(nn.Module):
    """The JAX ``BatchNorm``: ``y = x*a + b`` with ``a = scale * rsqrt(var +
    eps)``, ``b = bias - mean*a`` in f32, cast once to x's dtype.

    In train mode ``mean``/``var`` are the batch moments over (N, H, W):
    sums of ``x`` and of ``x**2`` (squared in x's dtype, as JAX does)
    accumulated in f32 (f64 in an f64 model), and the *biased* variance
    ``E[x^2] - E[x]^2`` clamped at 0; gradients flow through both.  Under
    a data axis of more than one rank the sums and counts are all-reduced
    over the data group first, so the moments are the global batch's, as
    JAX's sharded reduction gives them (a recomputation under
    :func:`remat` all-reduces again).  The running
    statistics then move as ``0.9*old + 0.1*batch`` (flax momentum 0.9),
    except in the second run of a block under :func:`remat`.
    ``nn.BatchNorm2d`` is not used: it updates the running variance with
    the unbiased one.  No ``num_batches_tracked``: the flax tree has none.
    """

    MOMENTUM = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps

    def forward(self, x):
        if self.training:
            dims = (0, 2, 3)
            n = x.numel() // x.shape[1]
            acc = torch.promote_types(x.dtype, torch.float32)
            s1 = x.sum(dims, dtype=acc)
            s2 = x.square().sum(dims, dtype=acc)
            if distributed.data_shard()[0] > 1:
                # the global batch's moments: [sum x, sum x^2, n] over the
                # data group, the gradient flowing back through the sum
                C = s1.shape[0]
                sums = distributed.sum_with_grad(torch.cat(
                    [s1, s2, s1.new_full((1,), float(n))]))
                s1, s2, n = sums[:C], sums[C:2 * C], sums[2 * C]
            mean = s1 / n
            mean_sq = s2 / n
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            if not getattr(_recompute, "on", False):
                with torch.no_grad():
                    m = self.MOMENTUM
                    self.running_mean.copy_(m * self.running_mean
                                            + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        return (x * a.to(x.dtype)[None, :, None, None]
                + b.to(x.dtype)[None, :, None, None])


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + activation, pad = dilation * (k - 1) // 2.
    With ``use_bn=False`` the conv has a bias and there is no
    ``BatchNorm_0``, as in flax."""

    def __init__(self, c1: int, c2: int, kernel: int = 3, stride: int = 1,
                 act: str = "leaky", dtype: torch.dtype = torch.float32,
                 use_bn: bool = True, dilation: int = 1,
                 init: str = "lecun_normal"):
        super().__init__()
        self.Conv_0 = Conv(c1, c2, kernel, stride, bias=not use_bn,
                           dtype=dtype, dilation=dilation, init=init)
        self.BatchNorm_0 = BatchNorm(c2) if use_bn else None
        self.act = ACTIVATIONS[act]

    def forward(self, x):
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return self.act(x)


def max_pool(x, window: int, stride: int, pad: int = 0):
    """torch-style MaxPool2d over NCHW (implicit -inf padding)."""
    return F.max_pool2d(x, window, stride, pad)


def space_to_depth(x, block: int = 2):
    """NCHW space-to-depth: [B, C, H, W] -> [B, C*b*b, H/b, W/b].

    Channel index ``(i*b + j)*C + c`` for row phase i and column phase j,
    as the JAX ``space_to_depth`` orders its NHWC channels.
    """
    B, C, H, W = x.shape
    t = x.reshape(B, C, H // block, block, W // block, block)
    t = t.permute(0, 3, 5, 1, 2, 4)        # [B, i, j, C, H/b, W/b]
    return t.reshape(B, block * block * C, H // block, W // block)


def reorg_darknet_bug(x):
    """The darknet "reorg" passthrough, NCHW [B, C, H, W] -> [B, 4C, H/2,
    W/2]: a view/permute of channel blocks that scrambles (channel,
    position) pairs, unlike a true space-to-depth; kept so weights carried
    over from darknet reproduce its forward."""
    B, C, H, W = x.shape
    t = x.reshape(B, C // 4, H, 2, W, 2).permute(0, 3, 5, 1, 2, 4)
    return t.reshape(B, 4 * C, H // 2, W // 2)


def upsample2x(x):
    """Nearest-neighbor 2x upsample, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """float32 [n_in, n_out]: the interpolation matrix ``jax.image.resize``
    builds (``compute_weight_mat``): half-pixel sample positions, the
    triangle kernel widened by the downscale factor (its antialiasing),
    each column divided by its sum, so a sample left of the first centre
    (or right of the last) takes the edge pixel; samples outside the
    input get no weight."""
    inv_scale = 1.0 / (n_out / n_in)
    f32 = np.float32
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


_RESIZE_MATRICES: dict = {}   # (n_in, n_out, device, dtype) -> matrix


def _resize_matrix(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """:func:`_resize_weights` on ``device`` in ``dtype``, copied there on
    the first eager call only (``device.device_table``: a trace never
    fills the cache)."""
    return device_table(
        _RESIZE_MATRICES, (n_in, n_out, device, dtype),
        lambda: torch.from_numpy(_resize_weights(n_in, n_out)).to(device,
                                                                  dtype))


def resize_bilinear(x, size: Sequence[int]):
    """Bilinear resize of NCHW ``x`` to ``size`` (H, W):
    ``jax.image.resize(method="bilinear")`` as JAX computes it, two
    contractions with its interpolation matrices (:func:`_resize_weights`)
    cast to x's dtype, the one with the smaller intermediate first (H on a
    tie), as JAX's einsum orders them; in bf16 the intermediate rounds to
    bf16 as JAX's does.  ``F.interpolate`` (bilinear,
    ``align_corners=False``) is 6.7e-6 off JAX on 38 -> 75 in f32, and in
    bf16 keeps f32 weights and one rounding where JAX rounds three times
    (``tests/test_torch_port_anchor_models.py``)."""
    H, W = x.shape[2], x.shape[3]
    wh = _resize_matrix(H, size[0], x.device, x.dtype)
    ww = _resize_matrix(W, size[1], x.device, x.dtype)
    if H * size[1] < size[0] * W:      # W first: the smaller intermediate
        return wh.t() @ (x @ ww)
    return (wh.t() @ x) @ ww


class Residual(nn.Module):
    """1x1 to ``mid`` then 3x3 back to ``ch`` (leaky), plus the input."""

    def __init__(self, ch: int, mid: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBN_0 = ConvBN(ch, mid, 1, dtype=dtype)
        self.ConvBN_1 = ConvBN(mid, ch, 3, dtype=dtype)

    def forward(self, x):
        return x + self.ConvBN_1(self.ConvBN_0(x))


class MishResBlock(nn.Module):
    """``nblocks`` x (1x1 + 3x3 mish ConvBN, plus the input)."""

    def __init__(self, ch: int, nblocks: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nblocks = nblocks
        for i in range(2 * nblocks):
            self.add_module(f"ConvBN_{i}", ConvBN(ch, ch, 3 if i % 2 else 1,
                                                  act="mish", dtype=dtype))

    def forward(self, x):
        for i in range(self.nblocks):
            h = getattr(self, f"ConvBN_{2 * i}")(x)
            x = x + getattr(self, f"ConvBN_{2 * i + 1}")(h)
        return x


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax's conv init from a seeded generator: each kernel by its
    ``Conv.init`` (flax ``variance_scaling``: variance scale / fan, the fan
    over the receptive field times the in, out or mean channel count;
    "truncated_normal" cut at 2 stddev), biases 0.  BatchNorm keeps its
    constructor values (scale 1, bias 0, mean 0, var 1), as flax
    initialises them."""
    for m in model.modules():
        if isinstance(m, Conv):
            scale, mode, dist = KERNEL_INITS[m.init]
            c2, c1, kh, kw = m.weight.shape
            fan = {"fan_in": c1 * kh * kw, "fan_out": c2 * kh * kw,
                   "fan_avg": (c1 + c2) * kh * kw / 2}[mode]
            std = (scale / fan) ** 0.5
            if dist == "normal":
                m.weight.normal_(0.0, std, generator=generator)
            else:
                std /= _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def scale_ch(c: int, width_multiple: float) -> int:
    """Width-multiple channel scaling."""
    return int(round(c * width_multiple, 1))


def scale_depth(n: int, depth_multiple: float) -> int:
    return max(1, int(round(n * depth_multiple, 1)))


class BottleneckV5(nn.Module):
    """Standard v5 bottleneck: 1x1 -> 3x3, residual when shapes allow."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 e: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        c_ = int(c2 * e)
        self.ConvBN_0 = ConvBN(c1, c_, 1, dtype=dtype)
        self.ConvBN_1 = ConvBN(c_, c2, 3, dtype=dtype)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        h = self.ConvBN_1(self.ConvBN_0(x))
        return x + h if self.add else h


class BottleneckCSP(nn.Module):
    """CSP bottleneck: ``Conv_0`` closes the bottleneck branch y1,
    ``Conv_1`` is the 1x1 on the input x; BN + leaky act on ``[y1, y2]``."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        c_ = int(c2 * e)
        self.ConvBN_0 = ConvBN(c1, c_, 1, dtype=dtype)
        self.n = n
        for i in range(n):
            self.add_module(f"BottleneckV5_{i}",
                            BottleneckV5(c_, c_, shortcut, e=1.0, dtype=dtype))
        self.Conv_0 = Conv(c_, c_, 1, dtype=dtype)
        self.Conv_1 = Conv(c1, c_, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(2 * c_)
        self.ConvBN_1 = ConvBN(2 * c_, c2, 1, dtype=dtype)

    def forward(self, x):
        y1 = self.ConvBN_0(x)
        for i in range(self.n):
            y1 = getattr(self, f"BottleneckV5_{i}")(y1)
        y = torch.cat([self.Conv_0(y1), self.Conv_1(x)], dim=1)
        y = F.leaky_relu(self.BatchNorm_0(y), 0.1)
        return self.ConvBN_1(y)


class SPP(nn.Module):
    """Spatial pyramid pooling 5/9/13: 1x1 halve -> [x, pools] -> 1x1."""

    def __init__(self, c1: int, c2: int, kernels: Sequence[int] = (5, 9, 13),
                 act: str = "leaky", dtype: torch.dtype = torch.float32):
        super().__init__()
        c_ = c1 // 2
        self.kernels = tuple(kernels)
        self.ConvBN_0 = ConvBN(c1, c_, 1, act=act, dtype=dtype)
        self.ConvBN_1 = ConvBN(c_ * (len(self.kernels) + 1), c2, 1, act=act,
                               dtype=dtype)

    def forward(self, x):
        x = self.ConvBN_0(x)
        pools = [max_pool(x, k, 1, k // 2) for k in self.kernels]
        return self.ConvBN_1(torch.cat([x] + pools, dim=1))


class Focus(nn.Module):
    """Space-to-depth + conv stem."""

    def __init__(self, c1: int, c2: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBN_0 = ConvBN(4 * c1, c2, kernel, dtype=dtype)

    def forward(self, x):
        return self.ConvBN_0(space_to_depth(x, 2))
