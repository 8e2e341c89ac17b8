"""Mosquito-Container parser: the port's copy of
``objectdetectionpl_tpu/data/parsers/container.py``.

VOC-style XML under train_cdc/train_annotations, images under
train_cdc/train_images.
"""

from __future__ import annotations

import glob
import os

from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.data.types import Example

CONTAINER_CLASSES = [
    "aquarium", "bottle", "bowl", "box", "bucket", "plastic_bag", "plate",
    "styrofoam", "tire", "toilet", "tub", "washing_machine", "water_tower"]


class ContainerParser:
    classes = CONTAINER_CLASSES

    def __init__(self, root: str):
        self.img_files = sorted(glob.glob(
            os.path.join(root, "train_cdc", "train_images", "*.jpg")))
        self.anno_dir = os.path.join(root, "train_cdc", "train_annotations")

    def __len__(self):
        return len(self.img_files)

    def record(self, i: int):
        img_path = self.img_files[i]
        stem = os.path.splitext(os.path.basename(img_path))[0]
        boxes, labels = common.parse_voc_xml(
            os.path.join(self.anno_dir, f"{stem}.xml"), self.classes)
        return img_path, boxes, labels

    def __getitem__(self, i: int) -> Example:
        path, boxes, labels = self.record(i)
        return common.make_example(path, boxes, labels)
