"""Synthetic detection dataset: colored rectangles on noise backgrounds.

The port's copy of ``objectdetectionpl_tpu/data/synthetic.py``: the same
``RandomState`` seeding and draws, so an index gives the same image, boxes
and labels in both packages, bit for bit.  Deterministic per index and
learnable (boxes are visually distinct rectangles).
"""

from __future__ import annotations

import numpy as np

from objectdetectionpl_tpu_torch.data.types import Example

SYNTHETIC_CLASSES = ["square", "wide", "tall"]


class SyntheticParser:
    classes = SYNTHETIC_CLASSES

    def __init__(self, size: int = 64, img_hw: int = 256, max_objects: int = 4,
                 seed: int = 0):
        self.size = size
        self.img_hw = img_hw
        self.max_objects = max_objects
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, i: int) -> Example:
        rng = np.random.RandomState(self.seed * 100003 + i)
        S = self.img_hw
        img = rng.randint(0, 40, (S, S, 3)).astype(np.uint8)
        n = rng.randint(1, self.max_objects + 1)
        boxes, labels = [], []
        for _ in range(n):
            cls = rng.randint(0, 3)
            base = rng.randint(S // 8, S // 3)
            if cls == 1:      # wide
                w, h = base * 2, base
            elif cls == 2:    # tall
                w, h = base, base * 2
            else:             # square
                w = h = base
            w, h = min(w, S - 2), min(h, S - 2)
            x = rng.randint(0, S - w)
            y = rng.randint(0, S - h)
            color = np.array([(200, 60, 60), (60, 200, 60), (60, 60, 200)][cls])
            img[y:y + h, x:x + w] = color + rng.randint(-20, 20, 3)
            boxes.append([x, y, w, h])
            labels.append(cls)
        return Example(img, np.asarray(boxes, np.float32),
                       np.asarray(labels, np.int32))
