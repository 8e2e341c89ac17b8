"""The one generator of every traffic mix: image pools, COCO-like targets
and augmentation uniforms, all drawn from the run's seed by the
parameters of a traffic file (``perfbench/traffic/<name>.json``).

Images are uint8 NHWC noise drawn on the device and kept in pinned host
memory; targets are padded to ``max_boxes``: labels [n, B, M] int32,
boxes [n, B, M, 4] center-form normalized float32, mask [n, B, M] bool.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import seeds


def image_pool(seed: int, n: int, B: int, S: int, device) -> torch.Tensor:
    """[n, B, S, S, 3] uint8, pinned on the host when ``device`` is a card."""
    g = seeds.torch_generator(seed, "images", device)
    cuda = torch.device(device).type == "cuda"
    pool = torch.empty((n, B, S, S, 3), dtype=torch.uint8, pin_memory=cuda)
    for i in range(n):
        pool[i].copy_(torch.randint(0, 256, (B, S, S, 3), generator=g,
                                    dtype=torch.uint8, device=device))
    return pool


def _zipf(k: int, s: float) -> np.ndarray:
    p = (np.arange(k) + 1.0) ** -s
    return p / p.sum()


def targets(seed: int, n: int, B: int, S: int, spec: dict, num_classes: int):
    """COCO-like targets by ``spec``: objects an image ``round(lognormal)``
    clipped to [1, max_boxes]; each object's size band by ``area_shares``
    (side length log-uniform within the band, in pixels), its aspect
    ratio log-uniform within ``aspect``, its centre uniform so the box
    lies inside the image, its class Zipf-distributed."""
    rng = seeds.numpy_rng(seed, "targets")
    M = spec["max_boxes"]
    obj = spec["objects"]
    counts = np.clip(np.rint(rng.lognormal(np.log(obj["median"]),
                                           obj["sigma"], (n, B))),
                     1, M).astype(np.int64)
    bands = list(spec["area_shares"].values())
    shares = np.array([b["share"] for b in bands])
    band = rng.choice(len(bands), (n, B, M), p=shares / shares.sum())
    lo = np.log(np.array([b["side_px"][0] for b in bands])[band])
    hi = np.log(np.minimum(np.array([b["side_px"][1] for b in bands])[band],
                           spec["max_side"] * S))
    side = np.exp(rng.uniform(np.minimum(lo, hi), hi)) / S
    ar = np.exp(rng.uniform(np.log(spec["aspect"][0]),
                            np.log(spec["aspect"][1]), (n, B, M)))
    w = np.minimum(side * np.sqrt(ar), spec["max_side"])
    h = np.minimum(side / np.sqrt(ar), spec["max_side"])
    cx = w / 2 + rng.uniform(0, 1, (n, B, M)) * (1 - w)
    cy = h / 2 + rng.uniform(0, 1, (n, B, M)) * (1 - h)
    labels = rng.choice(num_classes, (n, B, M),
                        p=_zipf(num_classes, spec["class_zipf"]))
    mask = np.arange(M)[None, None, :] < counts[..., None]
    boxes = np.stack([cx, cy, w, h], -1).astype(np.float32)
    return (torch.from_numpy(labels.astype(np.int32)),
            torch.from_numpy(np.where(mask[..., None], boxes, 0.0)
                             .astype(np.float32)),
            torch.from_numpy(mask))


def uniforms(seed: int, n: int, B: int, device) -> torch.Tensor:
    """[n, B, 14] float32 augmentation uniforms on ``device``."""
    return torch.rand((n, B, 14), device=device,
                      generator=seeds.torch_generator(seed, "uniforms",
                                                      device))
