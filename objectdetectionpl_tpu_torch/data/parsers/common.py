"""Shared parser helpers (image IO, VOC-style XML): the port's copy of
``objectdetectionpl_tpu/data/parsers/common.py``.

Images are read as ``cv2.imread`` (the JAX package's ``load_image_rgb``)
reads them, by ``native.decode_image``: the reader picked by the file's
first bytes (JPEG by the port's decoder, PNG and BMP by
``data/formats.py``), turned by their EXIF orientation; a file it cannot
read raises ``native.ImageError`` (an ``OSError``) naming the path.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np

from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.types import Example


def load_image_rgb(path: str) -> np.ndarray:
    """uint8 RGB HWC as ``cv2.imread`` reads it: ``native.decode_image``."""
    return native.decode_image(path, exif=True)


def parse_voc_xml(xml_path: str, classes: Sequence[str],
                  offset: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """VOC bndbox XML -> (boxes top-left xywh px, labels).

    Coordinates get a -1 offset and degenerate boxes are dropped, as in
    the JAX package.
    """
    annot = ET.parse(xml_path)
    boxes: List[List[float]] = []
    labels: List[int] = []
    for obj in annot.findall("object"):
        bnd = obj.find("bndbox")
        xmin, xmax, ymin, ymax = (
            float(bnd.find(t).text) - offset
            for t in ("xmin", "xmax", "ymin", "ymax"))
        name = obj.find("name").text.lower().strip()
        if name not in classes:
            continue
        w, h = xmax - xmin, ymax - ymin
        if xmin >= 0 and ymin >= 0 and w >= 0 and h >= 0:
            boxes.append([xmin, ymin, w, h])
            labels.append(classes.index(name))
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int32))


def make_example(img_path: str, boxes: np.ndarray,
                 labels: np.ndarray) -> Example:
    return Example(load_image_rgb(img_path), boxes, labels)


def read_id_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def exists(p: str) -> bool:
    return os.path.exists(p)
