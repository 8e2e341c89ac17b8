"""The batch augmentation replayed from its uniforms, in plain float32
PyTorch: the frozen reference of the port's ``data/augment.py::
augment_batch`` on one process, with the bilinear warp written out.

``u`` [B, 14] holds every random number: coins and spans of the
horizontal and vertical flips (0, 1), shift-scale-rotate (2: coin; 3-6:
angle, scale, x and y shift), brightness/contrast (7: coin; 8, 9) and RGB
shift (10: coin; 11-13).  Shift-scale-rotate runs on K = max(1, min(B,
round(2 p B))) slots claimed by the K smallest SSR coins; an image is
warped when its coin is under p and it holds a slot.
"""

from __future__ import annotations

import math

import torch


def span(v, lim):
    return (v * 2.0 - 1.0) * lim


def forward_matrices(angle, scale, tx, ty):
    """[B, 3, 3] input->output affines about the image centre, in the
    normalized [0, 1] frame."""
    B, dev = angle.shape[0], angle.device
    c, s = torch.cos(angle), torch.sin(angle)
    rot = torch.zeros(B, 3, 3, device=dev)
    rot[:, 0, 0], rot[:, 0, 1] = c * scale, -s * scale
    rot[:, 1, 0], rot[:, 1, 1] = s * scale, c * scale
    rot[:, 2, 2] = 1.0
    center = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5],
                           [0.0, 0.0, 1.0]], device=dev)
    uncenter = torch.tensor([[1.0, 0.0, -0.5], [0.0, 1.0, -0.5],
                             [0.0, 0.0, 1.0]], device=dev)
    shift = torch.eye(3, device=dev).repeat(B, 1, 1)
    shift[:, 0, 2], shift[:, 1, 2] = tx, ty
    return shift @ center @ rot @ uncenter


def warp_plan(u, cfg: dict):
    """(top [K] slot images, applied [B], forward [B, 3, 3] with the
    identity where SSR is not applied) of a batch's uniforms."""
    B = u.shape[0]
    K = max(1, min(B, int(round(B * min(2.0 * cfg["p_ssr"], 1.0)))))
    top = torch.sort(u[:, 2], stable=True).indices[:K]
    covered = torch.zeros(B, dtype=torch.bool, device=u.device)
    covered[top] = True
    do = u[:, 2] < cfg["p_ssr"]
    ang = span(u[:, 3], cfg["rotate_limit"]) * (math.pi / 180.0) * do
    scale = 1.0 + span(u[:, 4], cfg["scale_limit"]) * do
    tx = span(u[:, 5], cfg["shift_limit"]) * do
    ty = span(u[:, 6], cfg["shift_limit"]) * do
    applied = do & covered
    fwd = torch.where(applied[:, None, None],
                      forward_matrices(ang, scale, tx, ty),
                      torch.eye(3, device=u.device)[None])
    return top, applied, fwd


def warp(images, inv):
    """Inverse-warp [K, H, W, C] by [K, 3, 3] (normalized frame, pixel
    centres at (x + 0.5) / W): bilinear, 0 outside the image."""
    K, H, W, C = images.shape
    dev = images.device
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    m = inv[:, :, :, None, None]
    sx = (m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]) * W - 0.5
    sy = (m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]) * H - 0.5
    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    sx = torch.where(inside, sx, 0.0).clamp(0.0, W - 1.0)
    sy = torch.where(inside, sy, 0.0).clamp(0.0, H - 1.0)
    x0, y0 = sx.long(), sy.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    dx, dy = (sx - x0)[..., None], (sy - y0)[..., None]
    k = torch.arange(K, device=dev)[:, None, None]
    px = lambda yi, xi: images[k, yi, xi]
    top = px(y0, x0) * (1 - dx) + px(y0, x1) * dx
    bot = px(y1, x0) * (1 - dx) + px(y1, x1) * dx
    return torch.where(inside[..., None], top * (1 - dy) + bot * dy, 0.0)


def augment(images, boxes, mask, u, cfg: dict):
    """images [B, S, S, 3] float32 in [0, 1], boxes [B, M, 4] center-form
    normalized, mask [B, M] -> new (images, boxes, mask)."""
    per_image = lambda v: v[:, None, None, None]
    for coin, p, dim, field in ((0, cfg["p_hflip"], 2, 0),
                                (1, cfg["p_vflip"], 1, 1)):
        do = u[:, coin] < p
        images = torch.where(per_image(do), images.flip(dim), images)
        flipped = boxes.clone()
        flipped[..., field] = 1.0 - boxes[..., field]
        boxes = torch.where(do[:, None, None], flipped, boxes)
    do = u[:, 7] < cfg["p_brightness"]
    beta = span(u[:, 8], cfg["brightness_limit"]) * do
    alpha = 1.0 + span(u[:, 9], cfg["contrast_limit"]) * do
    images = (images * per_image(alpha) + per_image(beta)).clamp(0.0, 1.0)
    do = u[:, 10] < cfg["p_rgb_shift"]
    shift = span(u[:, 11:14], cfg["rgb_shift_limit"]) * do[:, None]
    images = (images + shift[:, None, None, :]).clamp(0.0, 1.0)

    top, applied, fwd = warp_plan(u, cfg)
    cx, cy, w, h = boxes.unbind(-1)
    xs = torch.stack([cx - w / 2, cx + w / 2, cx - w / 2, cx + w / 2], -1)
    ys = torch.stack([cy - h / 2, cy - h / 2, cy + h / 2, cy + h / 2], -1)
    pts = torch.stack([xs, ys, torch.ones_like(xs)], -2)       # [B, M, 3, 4]
    out = torch.einsum("bij,bmjk->bmik", fwd, pts)
    x1, x2 = out[:, :, 0].amin(-1).clamp(0, 1), out[:, :, 0].amax(-1).clamp(0, 1)
    y1, y2 = out[:, :, 1].amin(-1).clamp(0, 1), out[:, :, 1].amax(-1).clamp(0, 1)
    new = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
    alive = mask & (new[..., 2] > 1e-4) & (new[..., 3] > 1e-4)
    boxes = torch.where(mask[..., None], new, boxes)

    inv = torch.linalg.inv(fwd[top])
    slots = images[top]
    slots = torch.where(applied[top][:, None, None, None], warp(slots, inv),
                        slots)
    images = images.index_copy(0, top, slots)
    return images, boxes, alive
