"""WiderPerson parser: the port's copy of
``objectdetectionpl_tpu/data/parsers/widerperson.py``.

Split lists <root>/<split>.txt; per-image annotations at
<root>/Annotations/<id>.jpg.txt — first line is the count, then
``label x1 y1 x2 y2`` rows with 1-based labels.
"""

from __future__ import annotations

import os

import numpy as np

from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.data.types import Example

WIDERPERSON_CLASSES = ["pedestrians", "riders", "partially-visible persons",
                       "ignore regions", "crowd"]


class WiderPersonParser:
    classes = WIDERPERSON_CLASSES

    def __init__(self, root: str, split: str = "train"):
        self.image_dir = os.path.join(root, "Images")
        self.anno_dir = os.path.join(root, "Annotations")
        self.ids = common.read_id_list(os.path.join(root, f"{split}.txt"))
        self.has_annotations = split != "test"

    def __len__(self):
        return len(self.ids)

    def record(self, i: int):
        _id = self.ids[i]
        boxes, labels = [], []
        if self.has_annotations:
            anno = os.path.join(self.anno_dir, f"{_id}.jpg.txt")
            with open(anno, encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split(" ")
                    if len(parts) == 1:        # leading count line
                        continue
                    label, x1, y1, x2, y2 = (int(v) for v in parts)
                    w, h = x2 - x1, y2 - y1
                    if x1 >= 0 and y1 >= 0 and w >= 0 and h >= 0:
                        boxes.append([x1, y1, w, h])
                        labels.append(label - 1)
        return (os.path.join(self.image_dir, f"{_id}.jpg"),
                np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int32))

    def __getitem__(self, i: int) -> Example:
        path, boxes, labels = self.record(i)
        return common.make_example(path, boxes, labels)
