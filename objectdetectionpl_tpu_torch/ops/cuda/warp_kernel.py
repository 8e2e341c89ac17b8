"""Batched inverse affine bilinear warp of gathered slots: the Hopper kernel
``csrc/affine_warp.cu`` and its plain PyTorch versions.

The counterpart of ``objectdetectionpl_tpu/ops/pallas/warp_kernel.py``
(``affine_warp_batch``), with the semantics of the JAX gather warp
``objectdetectionpl_tpu/data/augment.py::_affine_warp`` rather than of the
TPU kernel: the TPU kernel splits the warp into two 1-D shear/scale passes
(matrix products on the MXU, because gathers are slow there), which adds
half-texel smoothing and a ~2-texel border band and holds only for rotations
up to 45 degrees.  On Hopper the 4-tap gather is cheap, so the kernel is the
exact single-pass warp and is valid for every matrix.

:func:`affine_warp_slots` is the shift-scale-rotate tail of
``augment_batch`` minus its write-back: ``out[k] = use[k] ? warp(images[
top[k]], inv[k]) : images[top[k]]``, the JAX chain of
``objectdetectionpl_tpu/data/augment.py:205-210`` before the scatter.
:func:`affine_warp` warps every image it is given and runs the same kernel
with ``top = arange(K)`` and every ``use`` true.  Both check their inputs on
every device, take the plain version only for tensors on the CPU, and for
CUDA tensors launch the kernel or raise; ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from objectdetectionpl_tpu_torch.ops.cuda import _build

LAUNCHES = 0          # kernel launches by both wrappers since import (or reset)

# csrc/affine_warp.cu's tiling, mirrored by tile_plan (change both together)
TILE = 32             # kTile: output tiles of TILE x TILE pixels
RUN = 4               # kRun: pixels per thread, 16-byte aligned when vec
STAGE_BYTES = 30 * 1024   # kStageBytes: shared memory for a footprint
PATHS = ("copy", "staged", "global", "outside")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("affine_warp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.affine_warp_slots_launch.argtypes = [p, i, p, p, p, p, i, i, i, i, i,
                                             p]
    lib.affine_warp_slots_launch.restype = ctypes.c_int
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


def affine_warp_slots_plain(images: torch.Tensor, top: torch.Tensor,
                           inv: torch.Tensor, use: torch.Tensor
                           ) -> torch.Tensor:
    """``use[k] ? affine_warp_plain(images[top[k]], inv[k]) :
    images[top[k]]`` for the K slots, on any device: [K, H, W, C]."""
    slots = images[top]
    warped = affine_warp_plain(slots, inv)
    return torch.where(use[:, None, None, None], warped, slots)


def tile_plan(H: int, W: int, C: int, inv: torch.Tensor, use: torch.Tensor
              ) -> dict:
    """What the kernel does with each output tile of each slot, from the
    same f32 arithmetic on the CPU: ``path`` [K, tiles_y, tiles_x] indexes
    ``PATHS`` -- ``copy`` (``use`` false), ``staged`` (the source footprint
    in shared memory), ``global`` (taps read from device memory: the
    footprint exceeds ``STAGE_BYTES`` or a corner is not finite),
    ``outside`` (no pixel maps into the image: zeros); ``box`` [K, tiles_y,
    tiles_x, 4] is the staged footprint (x first, x last, y first, y last,
    inclusive, x aligned to ``RUN`` pixels when ``vec``); ``vec`` whether
    the kernel stores 16 bytes at a time (C = 3, W a multiple of 4).

    The footprint comes from the tile's four corners: each rounded step of
    the source coordinate is monotone in x and in y, so the corners bound
    every pixel's taps."""
    inv = inv.detach().to("cpu", torch.float32)
    use = use.detach().to("cpu", torch.bool)
    vec = C == 3 and W % RUN == 0
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    fw, fh = f32(float(W)), f32(float(H))
    x0s = torch.arange(0, W, TILE)
    y0s = torch.arange(0, H, TILE)
    xs = torch.stack([x0s, (x0s + TILE - 1).clamp(max=W - 1)])   # [2, tx]
    ys = torch.stack([y0s, (y0s + TILE - 1).clamp(max=H - 1)])   # [2, ty]
    xn = ((xs.float() + 0.5) / fw)[None, :, None, None, :]
    yn = ((ys.float() + 0.5) / fh)[None, None, :, :, None]
    m = inv.reshape(-1, 9)[:, :, None, None, None, None]
    # [K, 2 (corner y), 2 (corner x), ty, tx] source coordinates
    sx = (m[:, 0] * xn + m[:, 1] * yn + m[:, 2]) * fw - 0.5
    sy = (m[:, 3] * xn + m[:, 4] * yn + m[:, 5]) * fh - 0.5
    lo = lambda t: t.amin(dim=(1, 2))
    hi = lambda t: t.amax(dim=(1, 2))
    finite = (sx.isfinite() & sy.isfinite()).all(dim=1).all(dim=1)
    inside = (finite & (hi(sx) >= 0) & (lo(sx) <= W - 1) & (hi(sy) >= 0)
              & (lo(sy) <= H - 1))
    safe = lambda t: torch.where(inside, t, 0.0)
    fx0 = safe(lo(sx)).clamp(min=0).long()
    fx1 = (safe(hi(sx)).clamp(max=W - 1).long() + 1).clamp(max=W - 1)
    fy0 = safe(lo(sy)).clamp(min=0).long()
    fy1 = (safe(hi(sy)).clamp(max=H - 1).long() + 1).clamp(max=H - 1)
    if vec:
        fx0 = fx0 // RUN * RUN
        fx1 = fx1 // RUN * RUN + RUN - 1
    nbytes = (fx1 - fx0 + 1) * (fy1 - fy0 + 1) * C * 4
    path = torch.where(inside, torch.where(nbytes <= STAGE_BYTES, 1, 2),
                       torch.where(finite, 3, 2))
    path = torch.where(use[:, None, None], path, 0)
    return {"path": path, "box": torch.stack([fx0, fx1, fy0, fy1], -1),
            "vec": vec}


def path_counts(plan: dict) -> dict:
    """Tiles per path of a :func:`tile_plan`."""
    return {name: int((plan["path"] == i).sum())
            for i, name in enumerate(PATHS)}


def _check(images: torch.Tensor, inv: torch.Tensor, K: int,
           name: str = "affine_warp", batch: str = "K") -> None:
    if images.dim() != 4:
        raise ValueError(f"{name}: images must be [{batch}, H, W, C], got "
                         f"shape {tuple(images.shape)}")
    if tuple(inv.shape) != (K, 3, 3):
        raise ValueError(f"{name}: inv must have shape ({K}, 3, 3), got "
                         f"{tuple(inv.shape)}")
    for arg, t in (("images", images), ("inv", inv)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be torch.float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if inv.device != images.device:
        raise ValueError(f"{name}: inv is on {inv.device}, images on "
                         f"{images.device}")
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {images.device}")


def _check_slots(images, top, inv, use) -> None:
    name = "affine_warp_slots"
    if top.dim() != 1:
        raise ValueError(f"{name}: top must be [K], got shape "
                         f"{tuple(top.shape)}")
    K = top.shape[0]
    _check(images, inv, K, name, batch="B")
    if top.dtype != torch.int64:
        raise TypeError(f"{name}: top must be torch.int64, got {top.dtype}")
    if use.dtype != torch.bool:
        raise TypeError(f"{name}: use must be torch.bool, got {use.dtype}")
    if tuple(use.shape) != (K,):
        raise ValueError(f"{name}: use must have shape ({K},), got "
                         f"{tuple(use.shape)}")
    for arg, t in (("top", top), ("use", use)):
        if t.device != images.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, images on "
                             f"{images.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    # on the card an index outside [0, B) stops the kernel (a device-side
    # fault, as for an out-of-range tensor index): checking it here would
    # wait for the card
    if images.device.type == "cpu" and K and (
            int(top.min()) < 0 or int(top.max()) >= images.shape[0]):
        raise IndexError(f"{name}: top must lie in [0, {images.shape[0]})")


def _launch(images, top, inv, use) -> torch.Tensor:
    B, H, W, C = images.shape
    K = top.shape[0]
    out = torch.empty((K, H, W, C), dtype=images.dtype, device=images.device)
    if out.numel() == 0:
        return out
    vec = (C == 3 and W % RUN == 0 and images.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    # the launch acts on the current device: make it the tensors' card
    with torch.cuda.device(images.device):
        err = _lib().affine_warp_slots_launch(
            images.data_ptr(), B, top.data_ptr(), inv.data_ptr(),
            use.data_ptr(), out.data_ptr(), K, H, W, C, int(vec),
            torch.cuda.current_stream(images.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"affine_warp kernel launch failed: cudaError "
                           f"{err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def affine_warp_slots(images: torch.Tensor, top: torch.Tensor,
                      inv: torch.Tensor, use: torch.Tensor) -> torch.Tensor:
    """Warp the K slots ``images[top]`` by ``inv``, keeping the slots whose
    ``use`` is false as they are; see :func:`affine_warp_slots_plain`.

    ``images`` [B, H, W, C] and ``inv`` [K, 3, 3] contiguous float32,
    ``top`` [K] int64 in [0, B), ``use`` [K] bool, all on one device.  CPU
    tensors go to the plain version; for CUDA tensors the kernel runs on
    the current stream.
    """
    _check_slots(images, top, inv, use)
    if images.device.type == "cpu":
        return affine_warp_slots_plain(images, top, inv, use)
    return _launch(images, top, inv, use)


def affine_warp(images: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Batched inverse affine warp; see :func:`affine_warp_plain` for the
    contract.

    ``images`` [K, H, W, C] and ``inv`` [K, 3, 3] must be contiguous
    float32 on one device.  CPU tensors go to the plain version; for CUDA
    tensors the kernel runs on the current stream.
    """
    _check(images, inv, images.shape[0] if images.dim() == 4 else -1)
    if images.device.type == "cpu":
        return affine_warp_plain(images, inv)
    K, dev = images.shape[0], images.device
    return _launch(images, torch.arange(K, device=dev), inv,
                   torch.ones(K, dtype=torch.bool, device=dev))
