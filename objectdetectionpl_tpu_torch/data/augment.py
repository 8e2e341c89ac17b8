"""Device-side batch augmentation: the port of ``augment_batch`` in ``objectdetectionpl_tpu/data/augment.py``.

The reference pipeline (Albumentations, per image, on the host):
HorizontalFlip(p=.2) + VerticalFlip(p=.2) + ShiftScaleRotate(p=.2) +
RandomBrightnessContrast(p=.2) + RGBShift(30, p=.2).  Here it is one batched
function on the images' device: the JAX package's ``vmap`` over images
becomes a batch dimension, and all randomness is one ``[B, 14]`` uniform
draw.  Boxes are center-form normalized and transformed analytically;
rotation maps a box to its enclosing axis-aligned box.

The shift-scale-rotate warp is the Hopper kernel ``csrc/affine_warp.cu``
(``ops/cuda/warp_kernel.py::affine_warp_slots``, which also gathers the
slots and keeps the unselected ones), the exact single-pass warp for
every matrix, so the JAX package's ``use_pallas`` switch and its fallback
for matrices outside the TPU kernel's range have no counterpart here.

``mosaic_batch`` is the YOLOv5-style 4-image paste that the Trainer runs
before ``augment_batch`` when ``cfg.mosaic > 0``; it scales each quadrant
with ``jax.image.scale_and_translate``'s linear weights, antialiased
(:func:`scale_translate_weights`), as two matrix products.

Under a process group of R ranks each rank holds b rows of a global
batch of R*b (``parallel/distributed.py::data_shard``): both functions
draw the global batch's uniforms from the rank's generator (seeded alike
on every rank) and keep the rank's rows, and mosaic's partners come from
the global batch (``gather_rows``).  So R ranks augment exactly as one
process augments the concatenation of their shards in rank order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from objectdetectionpl_tpu_torch.ops.cuda import warp_kernel
from objectdetectionpl_tpu_torch.parallel import distributed


class AugmentConfig(NamedTuple):
    p_hflip: float = 0.2
    p_vflip: float = 0.2
    p_ssr: float = 0.2          # shift-scale-rotate
    shift_limit: float = 0.0625
    scale_limit: float = 0.1
    rotate_limit: float = 45.0  # degrees
    p_brightness: float = 0.2
    brightness_limit: float = 0.2
    contrast_limit: float = 0.2
    p_rgb_shift: float = 0.2
    rgb_shift_limit: float = 30.0 / 255.0


def _span(v, lim):
    return (v * 2.0 - 1.0) * lim


def _rot_shift_scale_matrix(angle_rad, scale, tx, ty):
    """Forward affines (input->output) around the image center, normalized
    [0, 1] frame: [B] parameters -> [B, 3, 3]."""
    B = angle_rad.shape[0]
    dev = angle_rad.device
    c, s = torch.cos(angle_rad), torch.sin(angle_rad)
    rot = torch.zeros(B, 3, 3, device=dev)
    rot[:, 0, 0] = c * scale
    rot[:, 0, 1] = -s * scale
    rot[:, 1, 0] = s * scale
    rot[:, 1, 1] = c * scale
    rot[:, 2, 2] = 1.0
    center = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]],
                          device=dev)
    uncenter = torch.tensor([[1.0, 0.0, -0.5], [0.0, 1.0, -0.5],
                             [0.0, 0.0, 1.0]], device=dev)
    shift = torch.eye(3, device=dev).repeat(B, 1, 1)
    shift[:, 0, 2] = tx
    shift[:, 1, 2] = ty
    return shift @ center @ rot @ uncenter


def _transform_boxes(boxes, mask, fwd):
    """Map center-form normalized boxes [B, M, 4] through forward affines
    [B, 3, 3] and enclose; returns (boxes, mask with boxes that left the
    frame dropped)."""
    cx, cy, w, h = boxes.unbind(-1)
    corners_x = torch.stack([cx - w / 2, cx + w / 2, cx - w / 2, cx + w / 2],
                            -1)
    corners_y = torch.stack([cy - h / 2, cy - h / 2, cy + h / 2, cy + h / 2],
                            -1)
    pts = torch.stack([corners_x, corners_y, torch.ones_like(corners_x)],
                      -2)                                    # [B, M, 3, 4]
    out = torch.einsum("bij,bmjk->bmik", fwd, pts)
    x1 = out[:, :, 0].amin(-1).clamp(0.0, 1.0)
    x2 = out[:, :, 0].amax(-1).clamp(0.0, 1.0)
    y1 = out[:, :, 1].amin(-1).clamp(0.0, 1.0)
    y2 = out[:, :, 1].amax(-1).clamp(0.0, 1.0)
    new = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
    alive = mask & (new[..., 2] > 1e-4) & (new[..., 3] > 1e-4)
    return torch.where(mask[..., None], new, boxes), alive


def _augment_cheap(u, images, boxes, cfg: AugmentConfig):
    """Flips + colour jitter of a batch (u: [B, 14] pre-drawn uniforms)."""
    per_image = lambda v: v[:, None, None, None]

    def flip(do, img_dim, box_field):
        nonlocal images, boxes
        images = torch.where(per_image(do), images.flip(img_dim), images)
        flipped = boxes.clone()
        flipped[..., box_field] = 1.0 - boxes[..., box_field]
        boxes = torch.where(do[:, None, None], flipped, boxes)

    flip(u[:, 0] < cfg.p_hflip, 2, 0)               # horizontal: cx -> 1 - cx
    flip(u[:, 1] < cfg.p_vflip, 1, 1)               # vertical: cy -> 1 - cy

    do = u[:, 7] < cfg.p_brightness
    beta = _span(u[:, 8], cfg.brightness_limit) * do
    alpha = 1.0 + _span(u[:, 9], cfg.contrast_limit) * do
    images = (images * per_image(alpha) + per_image(beta)).clamp(0.0, 1.0)

    do = u[:, 10] < cfg.p_rgb_shift
    shift = _span(u[:, 11:14], cfg.rgb_shift_limit) * do[:, None]
    images = (images + shift[:, None, None, :]).clamp(0.0, 1.0)
    return images, boxes


def _ssr_params(u, cfg: AugmentConfig):
    """(forward matrices [B, 3, 3], applied? [B]) for shift-scale-rotate."""
    do = u[:, 2] < cfg.p_ssr
    ang = _span(u[:, 3], cfg.rotate_limit) * (math.pi / 180.0) * do
    scale = 1.0 + _span(u[:, 4], cfg.scale_limit) * do
    tx = _span(u[:, 5], cfg.shift_limit) * do
    ty = _span(u[:, 6], cfg.shift_limit) * do
    return _rot_shift_scale_matrix(ang, scale, tx, ty), do


def augment_batch(images: torch.Tensor, boxes: torch.Tensor,
                  mask: torch.Tensor, cfg: AugmentConfig = AugmentConfig(),
                  generator: Optional[torch.Generator] = None, u=None):
    """Augment a batch: images [B, S, S, 3] f32 in [0, 1], boxes [B, M, 4]
    center-form normalized, mask [B, M].  Returns new (images, boxes, mask).

    ``u`` [R*B, 14] uniforms of the global batch (R ranks, R = 1 without
    a process group) are drawn from ``generator`` on the images' device
    unless given (the tests hand in JAX's exact draw); the rank keeps its
    B rows.  The warp runs on K = max(1, min(RB, round(RB * min(2 p_ssr,
    1)))) slots of the global batch, claimed by the K smallest SSR coins
    (ties to the lower index, as ``lax.top_k``); an image is warped iff
    its coin selected SSR and it holds a slot, so with more than K
    selected coins the overflow skips SSR, image and boxes alike.  A rank
    holds min(B, K) of them, its smallest coins: every global slot among
    its rows, and others that copy their image.  No step syncs with the
    host.
    """
    B = images.shape[0]
    dev = images.device
    R, r = distributed.data_shard()
    if u is None:
        u = torch.rand((R * B, 14), generator=generator, device=dev)
    else:
        u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    K = max(1, min(R * B, int(round(R * B * min(2.0 * cfg.p_ssr, 1.0)))))
    covered = torch.zeros(R * B, dtype=torch.bool, device=dev)
    covered[torch.sort(u[:, 2], stable=True).indices[:K]] = True
    u, covered = u[r * B:(r + 1) * B], covered[r * B:(r + 1) * B]
    images, boxes = _augment_cheap(u, images, boxes, cfg)

    top = torch.sort(u[:, 2], stable=True).indices[:min(B, K)]

    fwd, do = _ssr_params(u, cfg)
    applied = do & covered
    fwd = torch.where(applied[:, None, None], fwd,
                      torch.eye(3, device=dev)[None])
    boxes, mask = _transform_boxes(boxes, mask, fwd)

    # inv_ex, not inv: inv checks for singular input, a host sync.  Only a
    # scale of 0 is singular; its non-finite inverse warps to zeros.
    inv, _ = torch.linalg.inv_ex(fwd[top])
    # one kernel gathers the slots, warps those that apply SSR and copies
    # the others; the write-back is a separate pass, since writing in place
    # would race with the kernel's reads of the same images
    slots = warp_kernel.affine_warp_slots(images, top, inv.contiguous(),
                                          applied[top])
    images.index_copy_(0, top, slots)
    return images, boxes, mask


# --- mosaic (YOLOv5-style 4-way paste) ------------------------------------------


def scale_translate_weights(in_size: int, out_size: int,
                            scale: torch.Tensor, translation: torch.Tensor
                            ) -> torch.Tensor:
    """float32 ``[..., in_size, out_size]``: the linear interpolation
    matrices of ``jax.image.scale_and_translate`` (``compute_weight_mat``,
    antialias on) for each scale and translation ``[...]``: output pixel
    ``o`` samples the input at ``(o + 0.5 - t)/scale - 0.5`` with the
    triangle kernel widened by ``max(1/scale, 1)``, each column divided by
    its sum (zero where the sum is at most 1000 eps), and no weight for a
    sample outside ``[-0.5, in_size - 0.5]``.  The same float32 operations
    in the same order as JAX."""
    dev = scale.device
    scale = scale.to(torch.float32)[..., None, None]
    translation = translation.to(torch.float32)[..., None, None]
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5) * inv_scale - translation * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=dev)[:, None]
    x = torch.abs(sample_f - src) / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=-2, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, w, 0.0)


def mosaic_batch(images: torch.Tensor, boxes: torch.Tensor,
                 labels: torch.Tensor, mask: torch.Tensor, p: float = 0.5,
                 generator: Optional[torch.Generator] = None,
                 centers=None, u_apply=None):
    """4-image mosaic: output i pastes images ``(i + k) % B``, k = 0..3,
    scaled into the quadrants top-left, top-right, bottom-left and
    bottom-right of a centre drawn from U[0.3, 0.7)^2; applied to image i
    when ``u_apply[i] < p``.  images [B, S, S, 3] f32, boxes [B, M, 4]
    center-form normalized, labels [B, M], mask [B, M]; returns new
    (images, boxes, labels, mask).  Each output keeps the M largest of its
    4M composited boxes (ties to the lower index, as ``lax.top_k``), a box
    of zero area or a padded one marked invalid.

    ``centers`` [R*B, 2] (x, y) and ``u_apply`` [R*B], the global batch's
    (R ranks, R = 1 without a process group), are drawn from ``generator``
    on the images' device unless given (the tests hand in JAX's draws);
    the rank keeps its B rows, and its partners ``(i + k) % RB`` are rows
    of the global batch, the first min(B, 3) of every rank gathered.  A quadrant's pixels
    are those whose ``arange(S)/S`` lies in it, compared in float32 as JAX
    compares them.  No step syncs with the host.
    """
    B, S = images.shape[0], images.shape[1]
    M = boxes.shape[1]
    dev = images.device
    f32 = torch.float32
    R, r = distributed.data_shard()
    if centers is None:
        centers = 0.3 + 0.4 * torch.rand((R * B, 2), generator=generator,
                                         device=dev)
    if u_apply is None:
        u_apply = torch.rand((R * B,), generator=generator, device=dev)
    rows = slice(r * B, (r + 1) * B)
    centers = torch.as_tensor(centers, dtype=f32, device=dev)[rows]
    apply = torch.as_tensor(u_apply, dtype=f32, device=dev)[rows] < p
    cx, cy = centers[:, 0], centers[:, 1]
    zero = torch.zeros_like(cx)
    # quadrant origins and sizes [B, 4]: TL, TR, BL, BR
    ox = torch.stack([zero, cx, zero, cx], 1)
    oy = torch.stack([zero, zero, cy, cy], 1)
    sx = torch.stack([cx, 1 - cx, cx, 1 - cx], 1)
    sy = torch.stack([cy, cy, 1 - cy, 1 - cy], 1)

    pos = torch.arange(S, dtype=f32, device=dev) / S
    in_x = (pos >= ox[..., None]) & (pos < (ox + sx)[..., None])
    in_y = (pos >= oy[..., None]) & (pos < (oy + sy)[..., None])
    # each quadrant's weights with the pixels outside it zeroed: the four
    # products then add up to JAX's where() over the quadrants exactly
    wx = scale_translate_weights(S, S, sx, ox * S) * in_x[:, :, None, :]
    wy = scale_translate_weights(S, S, sy, oy * S) * in_y[:, :, None, :]
    src = (torch.arange(r * B, (r + 1) * B, device=dev)[:, None]
           + torch.arange(4, device=dev)) % (R * B)         # [B, 4]
    pool = [images, boxes, labels, mask]
    if R > 1:
        # a partner on another rank is among its first c = min(B, 3) rows
        # (k <= 3), so only those cross ranks: rows of the rank's own B,
        # then of the R*c gathered ones
        c = min(B, 3)
        q, l = src // B, src % B
        src = torch.where(q == r, l, B + q * c + l)
        pool = [torch.cat([t, g]) for t, g in zip(
            pool, distributed.gather_rows([t[:c] for t in pool]))]
    g_images, g_boxes, g_labels, g_mask = pool
    # rows (y, c) times the x weights, then the y weights times rows
    # (c, x): two batched products of [S, S] matrices, no broadcast
    x = g_images[src].transpose(-1, -2).reshape(B, 4, S * 3, S)
    t = torch.matmul(x, wx).reshape(B, 4, S, 3 * S)
    canvas = torch.matmul(wy.transpose(-1, -2), t).sum(1)    # [B,y,(c,x)]
    canvas = canvas.reshape(B, S, 3, S).transpose(-1, -2).contiguous()

    b = g_boxes[src]                                        # [B,4,M,4]
    ox, oy, sx, sy = (t[..., None] for t in (ox, oy, sx, sy))

    def fma(o, x, s):
        # XLA fuses o + x*s into one multiply-add: the product is exact in
        # float64, and the sum is rounded there and then to float32
        return (o.double() + x.double() * s.double()).float()
    nb = torch.stack([fma(ox, b[..., 0], sx), fma(oy, b[..., 1], sy),
                      b[..., 2] * sx, b[..., 3] * sy], -1)
    valid = g_mask[src]
    area = torch.where(valid, nb[..., 2] * nb[..., 3], -1.0)
    nb, area = nb.reshape(B, 4 * M, 4), area.reshape(B, 4 * M)
    top = torch.sort(area, dim=1, descending=True, stable=True).indices[:, :M]
    m_boxes = torch.gather(nb, 1, top[..., None].expand(B, M, 4))
    m_labels = torch.gather(g_labels[src].reshape(B, 4 * M), 1, top)
    m_mask = (torch.gather(valid.reshape(B, 4 * M), 1, top)
              & (torch.gather(area, 1, top) > 0))

    def sel(mixed, kept):
        return torch.where(apply.reshape((B,) + (1,) * (mixed.ndim - 1)),
                           mixed, kept)
    return (sel(canvas, images), sel(m_boxes, boxes), sel(m_labels, labels),
            sel(m_mask, mask))
