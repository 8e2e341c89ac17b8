"""3x3 stride-1 SAME convolution, forward and gradients: the Hopper kernels
of ``csrc/conv3x3.cu`` and their plain PyTorch versions.

The counterpart of ``objectdetectionpl_tpu/ops/pallas/conv_kernel.py``, in
its layouts: x ``[B, H, W, C]`` (NHWC), w ``[3, 3, C, Co]`` (HWIO), f32
accumulation, the output in x's dtype; ``conv3x3_s1_wgrad`` returns an f32
``[3, 3, C, Co]``.  :class:`Conv3x3S1` is the JAX custom VJP: the input
gradient is the same forward kernel on the flipped, transposed weights
(:func:`rot_w`), the weight gradient the wgrad kernel and its split-K
reduction.  The TPU kernel's VMEM-sizing knobs (``group``, ``interpret``,
the row strips) have no counterpart here.

The model does not call these: its convolutions stay with cuDNN, as the JAX
package's stay with XLA.  ``tools/conv_bench.py`` drives them against cuDNN.

Every wrapper checks its inputs on every device, takes the plain version
only for tensors on the CPU, and for CUDA tensors launches its kernel or
raises; ``LAUNCHES`` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from objectdetectionpl_tpu_torch.ops.cuda import _build

# kernel launches since import (or reset), by kernel
LAUNCHES = {"conv3x3_s1": 0, "conv3x3_s1_wgrad": 0, "wgrad_reduce": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # the kernels' dtype codes
# csrc/conv3x3.cu's tile: wgrad output rows (9C) x columns (Co), and the
# pixel step every split chunk is a multiple of
TILE_ROWS, TILE_COLS, PIXEL_STEP = 128, 64, 32
WAVES = 4                # wgrad blocks per streaming multiprocessor to aim for
MIN_SPLIT_PIXELS = 256


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv3x3_fwd_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.conv3x3_wgrad_launch.argtypes = [p, p, p, i, i, i, i, i, i, ll, i, p]
    lib.conv3x3_wgrad_reduce_launch.argtypes = [p, p, i, i, p]
    for fn in (lib.conv3x3_fwd_launch, lib.conv3x3_wgrad_launch,
               lib.conv3x3_wgrad_reduce_launch):
        fn.restype = ctypes.c_int
    return lib


def rot_w(w: torch.Tensor) -> torch.Tensor:
    """The input-gradient kernel: both spatial taps flipped, C and Co
    swapped (a view)."""
    return w.flip((0, 1)).transpose(2, 3)


def _taps(x: torch.Tensor):
    """The nine shifted [B*H*W, C] f32 slices of zero-padded x, tap-major."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + H, dx:dx + W].reshape(-1, C)


def conv3x3_s1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3/s1 SAME conv on any device: w cast to x's dtype, nine [M, C] x
    [C, Co] products accumulated in f32, the sum cast to x's dtype.  On the
    card the products are full f32 only with
    ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default)."""
    B, H, W, _ = x.shape
    wf = w.to(x.dtype).float()
    acc = torch.zeros(B * H * W, w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for dy, dx, a in _taps(x):
        acc += a @ wf[dy, dx]
    return acc.view(B, H, W, -1).to(x.dtype)


def conv3x3_s1_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw of the 3x3/s1 conv on any device: per tap an f32 [C, M] x
    [M, Co] product -> [3, 3, C, Co] f32 (the f32 caveat of
    :func:`conv3x3_s1_plain` applies)."""
    C, Co = x.shape[-1], g.shape[-1]
    gf = g.float().reshape(-1, Co)
    out = torch.empty(3, 3, C, Co, dtype=torch.float32, device=x.device)
    for dy, dx, a in _taps(x):
        out[dy, dx] = a.T @ gf
    return out


def _check(fn: str, x: torch.Tensor, other: torch.Tensor, other_name: str,
           other_dtypes) -> None:
    if x.dim() != 4:
        raise ValueError(f"{fn}: x must be [B, H, W, C], got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{fn}: x must be torch.float32 or torch.bfloat16, "
                        f"got {x.dtype}")
    if other.dtype not in other_dtypes:
        raise TypeError(f"{fn}: {other_name} must be "
                        f"{' or '.join(map(str, other_dtypes))}, got "
                        f"{other.dtype}")
    for name, t in (("x", x), (other_name, other)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if other.device != x.device:
        raise ValueError(f"{fn}: {other_name} is on {other.device}, x on "
                         f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv, x [B, H, W, C] (f32 or bf16) @ w [3, 3, C,
    Co] (f32 or bf16, cast to x's dtype) -> [B, H, W, Co] in x's dtype, f32
    accumulation.  Both contiguous on one device; CPU tensors go to
    :func:`conv3x3_s1_plain`, CUDA tensors to the kernel on the current
    stream.  No VJP: use :func:`conv3x3_s1_op` for gradients."""
    _check("conv3x3_s1", x, w, "w", tuple(DTYPES))
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3_s1: w must be [3, 3, {x.shape[-1]}, Co], "
                         f"got shape {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3x3_s1_plain(x, w)
    B, H, W, C = x.shape
    Co = w.shape[-1]
    w = w.to(x.dtype)
    y = torch.empty(B, H, W, Co, dtype=x.dtype, device=x.device)
    if y.numel() == 0 or C == 0:
        return y.zero_()
    _launched("conv3x3_s1", _lib().conv3x3_fwd_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, C, Co,
        DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream))
    return y


def wgrad_splits(pixels: int, C: int, Co: int, sms: int) -> tuple:
    """(splits, chunk) of the wgrad reduction over ``pixels`` = B*H*W:
    enough chunks that output tiles x chunks fill a card of ``sms``
    streaming multiprocessors ``WAVES`` times, each chunk a multiple of
    ``PIXEL_STEP`` and at least ``MIN_SPLIT_PIXELS``.  Chunk s is the pixels
    [s * chunk, (s + 1) * chunk) of x flattened to [B*H*W, C]."""
    tiles = -(-9 * C // TILE_ROWS) * -(-Co // TILE_COLS)
    want = max(1, min(-(-WAVES * sms // tiles), pixels // MIN_SPLIT_PIXELS))
    chunk = -(-pixels // want)
    chunk = -(-chunk // PIXEL_STEP) * PIXEL_STEP
    return -(-pixels // chunk), chunk


def conv3x3_s1_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw of the 3x3/s1 conv: x [B, H, W, C], g [B, H, W, Co], both f32
    or both bf16 -> [3, 3, C, Co] f32, summed over the batch.  CPU tensors
    go to :func:`conv3x3_s1_wgrad_plain`; for CUDA tensors the wgrad kernel
    writes per-chunk f32 partials and the reduction kernel sums them in
    chunk order (the same result on every run)."""
    _check("conv3x3_s1_wgrad", x, g, "g", (x.dtype,))
    if g.dim() != 4 or g.shape[:3] != x.shape[:3]:
        raise ValueError(f"conv3x3_s1_wgrad: g must be "
                         f"[{', '.join(map(str, x.shape[:3]))}, Co], got "
                         f"shape {tuple(g.shape)}")
    if x.device.type == "cpu":
        return conv3x3_s1_wgrad_plain(x, g)
    B, H, W, C = x.shape
    Co = g.shape[-1]
    dw = torch.empty(3, 3, C, Co, dtype=torch.float32, device=x.device)
    if dw.numel() == 0 or x.numel() == 0:
        return dw.zero_()
    splits, chunk = wgrad_splits(
        B * H * W, C, Co,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = torch.empty(splits, 9 * C, Co, dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    _launched("conv3x3_s1_wgrad", lib.conv3x3_wgrad_launch(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), B, H, W, C, Co,
        splits, chunk, DTYPES[x.dtype], stream))
    _launched("wgrad_reduce", lib.conv3x3_wgrad_reduce_launch(
        partial.data_ptr(), dw.data_ptr(), dw.numel(), splits, stream))
    return dw


class Conv3x3S1(torch.autograd.Function):
    """Differentiable 3x3/s1 SAME conv: :func:`conv3x3_s1` forward; the
    backward of the JAX VJP, g cast to x's dtype, then ``dx =
    conv3x3_s1(g, rot_w(w))`` and ``dw = conv3x3_s1_wgrad(x, g)`` in w's
    dtype (each only where its input needs a gradient)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_s1(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_s1(g, rot_w(w).to(x.dtype).contiguous())
        if ctx.needs_input_grad[1]:
            dw = conv3x3_s1_wgrad(x, g).to(w.dtype)
        return dx, dw


def conv3x3_s1_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`conv3x3_s1` with gradients (:class:`Conv3x3S1`)."""
    return Conv3x3S1.apply(x, w)
