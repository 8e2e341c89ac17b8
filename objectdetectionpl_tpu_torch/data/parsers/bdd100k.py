"""BDD100K box-track parser: the port's copy of
``objectdetectionpl_tpu/data/parsers/bdd100k.py``.

Scalabel JSON per video folder; category remaps: pedestrian/other person ->
person, bicycle -> bike, motorcycle -> motor, trailer -> truck; 'other
vehicle' dropped.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.data.types import Example

BDD_CLASSES = ["bike", "bus", "car", "motor", "person", "rider",
               "traffic light", "traffic sign", "train", "truck"]

_REMAP = {"pedestrian": "person", "other person": "person",
          "bicycle": "bike", "motorcycle": "motor", "trailer": "truck"}


class BDD100KParser:
    classes = BDD_CLASSES

    def __init__(self, root: str, split: str = "train"):
        img_base = os.path.join(root, "images", "track", split)
        anno_dir = os.path.join(root, "labels", "box_track_20", split)
        self.records = []
        for anno_path in sorted(glob.glob(os.path.join(anno_dir, "*.json"))):
            folder = os.path.splitext(os.path.basename(anno_path))[0]
            with open(anno_path) as f:
                frames = json.load(f)
            for item in frames:
                objs = []
                for label in item.get("labels", []):
                    cat = _REMAP.get(label["category"], label["category"])
                    if cat == "other vehicle" or cat not in self.classes:
                        continue
                    b = label["box2d"]
                    x, y = b["x1"], b["y1"]
                    w, h = b["x2"] - b["x1"], b["y2"] - b["y1"]
                    if x >= 0 and y >= 0 and w >= 0 and h >= 0:
                        objs.append([x, y, w, h, self.classes.index(cat)])
                if objs:
                    self.records.append(
                        (os.path.join(img_base, folder, item["name"]), objs))

    def __len__(self):
        return len(self.records)

    def record(self, i: int):
        path, objs = self.records[i]
        arr = np.asarray(objs, np.float32).reshape(-1, 5)
        return path, arr[:, :4], arr[:, 4].astype(np.int32)

    def __getitem__(self, i: int) -> Example:
        path, boxes, labels = self.record(i)
        return common.make_example(path, boxes, labels)
