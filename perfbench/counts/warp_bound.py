"""The least time of the affine warp of one augmentation call: the K
slots read once and written once as float32, their matrices and flags
read; the coordinates of every pixel of the slots that are warped, and
the bilinear blend of each channel of those pixels whose source lies
inside the image.  The larger of the operations at the float32 peak and
the bytes at the HBM rate."""

from __future__ import annotations

import torch

from perfbench.counts import peaks

COORD_OPS = 20           # normalized position, 2x3 affine, scale, tests
BLEND_OPS_PER_CHANNEL = 9


def inside_pixels(H: int, W: int, inv: torch.Tensor) -> int:
    """Output pixels of the slots ``inv`` [n, 3, 3] whose source point lies
    inside the image, by the float32 test the warp makes."""
    dev = inv.device
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    m = inv[:, :, :, None, None]
    sx = (m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]) * W - 0.5
    sy = (m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]) * H - 0.5
    return int(((sx >= 0) & (sx <= W - 1) & (sy >= 0)
                & (sy <= H - 1)).sum())


def bound_s(K: int, H: int, W: int, C: int, inv_used: torch.Tensor) -> float:
    """Seconds for K slots of H x W x C of which the slots with matrices
    ``inv_used`` [n, 3, 3] are warped."""
    nbytes = 2 * K * H * W * C * 4 + K * 9 * 4 + K
    ops = (inv_used.shape[0] * H * W * COORD_OPS
           + inside_pixels(H, W, inv_used) * C * BLEND_OPS_PER_CHANNEL)
    return max(ops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
