"""COCO instances parser: the port's copy of
``objectdetectionpl_tpu/data/parsers/coco.py``.

91 raw category ids are remapped to 80 contiguous classes via the standard
class-id table.  Boxes come as top-left xywh.
"""

from __future__ import annotations

import json
import os

import numpy as np

from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.data.types import Example

COCO_CLASS_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90]

COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush"]

_ID_TO_CONTIGUOUS = {cid: i for i, cid in enumerate(COCO_CLASS_IDS)}


class COCOParser:
    classes = COCO_CLASSES

    def __init__(self, root: str, year: str = "2017", mode: str = "train"):
        self.image_dir = os.path.join(root, "images", f"{mode}{year}")
        ann_file = os.path.join(root, "annotations",
                                f"instances_{mode}{year}.json")
        with open(ann_file) as f:
            dataset = json.load(f)

        per_image = {img["id"]: {"file_name": img["file_name"], "objs": []}
                     for img in dataset["images"]}
        for ann in dataset.get("annotations", []):
            rec = per_image.get(ann["image_id"])
            if rec is None or ann["category_id"] not in _ID_TO_CONTIGUOUS:
                continue
            x, y, w, h = ann["bbox"]
            if w >= 0 and h >= 0:
                rec["objs"].append(
                    [x, y, w, h, _ID_TO_CONTIGUOUS[ann["category_id"]]])
        self.records = list(per_image.values())

    def __len__(self):
        return len(self.records)

    def record(self, i: int):
        rec = self.records[i]
        objs = np.asarray(rec["objs"], np.float32).reshape(-1, 5)
        return (os.path.join(self.image_dir, rec["file_name"]),
                objs[:, :4], objs[:, 4].astype(np.int32))

    def __getitem__(self, i: int) -> Example:
        path, boxes, labels = self.record(i)
        return common.make_example(path, boxes, labels)
