"""Pascal VOC parser: the port's copy of
``objectdetectionpl_tpu/data/parsers/pascal.py``.

Layout: <root>/VOC<year>/{JPEGImages,Annotations,ImageSets/Main}.
Split lists: ImageSets/Main/<split>.txt.
"""

from __future__ import annotations

import os

from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.data.types import Example

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor"]


class VOCParser:
    classes = VOC_CLASSES

    def __init__(self, root: str, year: str = "2012", split: str = "train"):
        base = os.path.join(root, f"VOC{year}")
        self.image_dir = os.path.join(base, "JPEGImages")
        self.anno_dir = os.path.join(base, "Annotations")
        self.ids = common.read_id_list(
            os.path.join(base, "ImageSets", "Main", f"{split}.txt"))

    def __len__(self):
        return len(self.ids)

    def record(self, i: int):
        """(img_path, boxes, labels): the Loader decodes a batch of these
        paths with one ``native.decode_batch`` call."""
        _id = self.ids[i]
        boxes, labels = common.parse_voc_xml(
            os.path.join(self.anno_dir, f"{_id}.xml"), self.classes)
        return os.path.join(self.image_dir, f"{_id}.jpg"), boxes, labels

    def __getitem__(self, i: int) -> Example:
        path, boxes, labels = self.record(i)
        return common.make_example(path, boxes, labels)
