"""Batched inverse affine bilinear warp: the Hopper kernel ``csrc/affine_warp.cu``
and its plain PyTorch version.

The counterpart of ``objectdetectionpl_tpu/ops/pallas/warp_kernel.py``
(``affine_warp_batch``), with the semantics of the JAX gather warp
``objectdetectionpl_tpu/data/augment.py::_affine_warp`` rather than of the
TPU kernel: the TPU kernel splits the warp into two 1-D shear/scale passes
(matrix products on the MXU, because gathers are slow there), which adds
half-texel smoothing and a ~2-texel border band and holds only for rotations
up to 45 degrees.  On Hopper the 4-tap gather is cheap, so the kernel is the
exact single-pass warp and is valid for every matrix.

:func:`affine_warp` checks its inputs on every device, takes the plain
version only for tensors on the CPU, and for CUDA tensors launches the
kernel or raises; ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from objectdetectionpl_tpu_torch.ops.cuda import _build

LAUNCHES = 0          # kernel launches by affine_warp since import (or reset)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("affine_warp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.affine_warp_launch.argtypes = [p, p, p, i, i, i, i, p]
    lib.affine_warp_launch.restype = ctypes.c_int
    return lib


def affine_warp_plain(images: torch.Tensor, inv: torch.Tensor
                      ) -> torch.Tensor:
    """Inverse-warp ``images`` [K, H, W, C] by ``inv`` [K, 3, 3], on any
    device.

    ``inv[k]`` maps normalized [0, 1] output coordinates to normalized input
    coordinates; pixel centers sit at ``(x + 0.5) / W``.  Bilinear over the
    four neighbours, 0 where the source point leaves the image.  The batched
    form of ``_affine_warp``, in its operation order.
    """
    K, H, W, C = images.shape
    dev = images.device
    # divide by a device tensor: CUDA torch turns division by a host scalar
    # into a multiplication by its reciprocal, which can differ by an ulp
    size = lambda n: torch.full((), float(n), device=dev)
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / size(H)
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / size(W)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    m = inv.to(torch.float32)[:, :, :, None, None]        # [K, 3, 3, 1, 1]
    sx = (m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]) * W - 0.5
    sy = (m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]) * H - 0.5

    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    # outside pixels are zeroed below whatever they gather; pointing them
    # at pixel 0 keeps a non-finite coordinate from indexing anywhere
    sx = torch.where(inside, sx, 0.0).clamp(0.0, W - 1.0)
    sy = torch.where(inside, sy, 0.0).clamp(0.0, H - 1.0)
    x0 = sx.to(torch.int64)
    y0 = sy.to(torch.int64)
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    dx = (sx - x0)[..., None]
    dy = (sy - y0)[..., None]

    flat = images.reshape(K, H * W, C)

    def take(yi, xi):
        idx = (yi * W + xi).reshape(K, H * W, 1).expand(K, H * W, C)
        return torch.gather(flat, 1, idx).reshape(K, H, W, C)

    top = take(y0, x0) * (1 - dx) + take(y0, x1) * dx
    bot = take(y1, x0) * (1 - dx) + take(y1, x1) * dx
    out = top * (1 - dy) + bot * dy
    return torch.where(inside[..., None], out, 0.0)


def _check(images: torch.Tensor, inv: torch.Tensor) -> None:
    if images.dim() != 4:
        raise ValueError(f"affine_warp: images must be [K, H, W, C], got "
                         f"shape {tuple(images.shape)}")
    K = images.shape[0]
    if tuple(inv.shape) != (K, 3, 3):
        raise ValueError(f"affine_warp: inv must have shape ({K}, 3, 3), "
                         f"got {tuple(inv.shape)}")
    for name, t in (("images", images), ("inv", inv)):
        if t.dtype != torch.float32:
            raise TypeError(f"affine_warp: {name} must be torch.float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"affine_warp: {name} must be contiguous")
    if inv.device != images.device:
        raise ValueError(f"affine_warp: inv is on {inv.device}, images on "
                         f"{images.device}")


def affine_warp(images: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Batched inverse affine warp; see :func:`affine_warp_plain` for the
    contract.

    ``images`` [K, H, W, C] and ``inv`` [K, 3, 3] must be contiguous
    float32 on one device.  CPU tensors go to the plain version; for CUDA
    tensors the kernel runs on the current stream.
    """
    _check(images, inv)
    if images.device.type == "cpu":
        return affine_warp_plain(images, inv)
    if images.device.type != "cuda":
        raise ValueError(f"affine_warp: unsupported device {images.device}")
    out = torch.empty_like(images)
    K, H, W, C = images.shape
    if out.numel() == 0:
        return out
    err = _lib().affine_warp_launch(
        images.data_ptr(), inv.data_ptr(), out.data_ptr(), K, H, W, C,
        torch.cuda.current_stream(images.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"affine_warp kernel launch failed: cudaError "
                           f"{err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
