"""Asia-Traffic parser: the port's copy of
``objectdetectionpl_tpu/data/parsers/asiatraffic.py``.

Ids from ImageSets/All.txt; VOC-style XML under Annotations/, images under
JPEGImages/.  4 classes.
"""

from __future__ import annotations

import os

from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.data.types import Example

ASIA_CLASSES = ["pedestrian", "vehicle", "scooter", "bicycle"]


class AsiaTrafficParser:
    classes = ASIA_CLASSES

    def __init__(self, root: str):
        self.image_dir = os.path.join(root, "JPEGImages")
        self.anno_dir = os.path.join(root, "Annotations")
        self.ids = common.read_id_list(
            os.path.join(root, "ImageSets", "All.txt"))

    def __len__(self):
        return len(self.ids)

    def record(self, i: int):
        _id = self.ids[i]
        boxes, labels = common.parse_voc_xml(
            os.path.join(self.anno_dir, f"{_id}.xml"), self.classes)
        return os.path.join(self.image_dir, f"{_id}.jpg"), boxes, labels

    def __getitem__(self, i: int) -> Example:
        path, boxes, labels = self.record(i)
        return common.make_example(path, boxes, labels)
