"""Dataset trees made of the committed fixture JPEGs, one layout per parser.

``data/testdata/`` holds a few small JPEGs, baseline and progressive, two
1280x720 frames (BDD100K's size, baseline and progressive) and one CMYK
file (``UNSUPPORTED``: libjpeg's RGB output, the fused route, refuses it,
cv2.imread and the port's parser route read it), with the SHA-256 of the decodable
ones' libjpeg decodes (``decoded_sha256.json``).  The functions here lay
those files out as each parser expects, cycling over ``names`` (by default
every decodable fixture, from 37x53 to 1280x720; hard links where the file
system allows, else copies), with annotations of 1-5 boxes per image drawn
from a seed:

    write_voc_tree(root, n_train=200, n_val=64, seed=0, names=None,
                   files=None)
    write_coco_tree(root, n_train=200, n_val=64, seed=0, names=None)
    write_bdd100k_tree(root, n_train=200, n_val=64, seed=0, names=None)
    write_widerperson_tree(root, n_train=200, n_val=64, seed=0, names=None)
    write_container_tree(root, n=200, seed=0, names=None)
    write_asiatraffic_tree(root, n=200, seed=0, names=None)

Each returns root.  The tests parse the mixed trees with both packages.
``chip_smoke.py`` times its fits on trees of the dataset's typical image
size: ``voc_420_q75_500x375.jpg`` (VOC2012's ~500x375),
``coco_420_q75_640x480.jpg`` (COCO 2017's ~640x480, and its WiderPerson
fit) and the two ``BDD_FRAMES`` (BDD100K's 1280x720).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from objectdetectionpl_tpu_torch.data.parsers.asiatraffic import \
    ASIA_CLASSES
from objectdetectionpl_tpu_torch.data.parsers.bdd100k import BDD_CLASSES
from objectdetectionpl_tpu_torch.data.parsers.coco import (COCO_CLASS_IDS,
                                                           COCO_CLASSES)
from objectdetectionpl_tpu_torch.data.parsers.container import \
    CONTAINER_CLASSES
from objectdetectionpl_tpu_torch.data.parsers.pascal import VOC_CLASSES
from objectdetectionpl_tpu_torch.data.parsers.widerperson import \
    WIDERPERSON_CLASSES

TESTDATA = Path(__file__).resolve().parents[1] / "data" / "testdata"
HASHES = TESTDATA / "decoded_sha256.json"
UNSUPPORTED = ("cmyk_q90_56x40.jpg",)
# BDD100K's frame size, baseline and progressive: hashed at 1/2, 1/4, 1/8
BDD_FRAMES = ("bdd_420_q75_1280x720.jpg",
              "bdd_progressive_420_q75_1280x720.jpg")


def fixtures() -> Dict[str, dict]:
    """{name: {"shape": [h, w, 3], "sha256": ...}} of every decodable
    fixture; the BDD_FRAMES also hold "scaled": {"2" | "4" | "8": {"shape",
    "sha256"}}, libjpeg's decodes at that scale_denom."""
    return json.loads(HASHES.read_text())


def decodable() -> List[str]:
    """The fixtures' names that the decoder reads, sorted."""
    return sorted(fixtures())


def _place(src: Path, dst: Path) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def _boxes(rng, w: int, h: int) -> List[Tuple[int, int, int, int]]:
    """1-5 boxes (xmin, ymin, xmax, ymax), 1-based pixel corners inside
    the image, each at least 2 px on a side where the image allows."""
    out = []
    for _ in range(rng.randint(1, 6)):
        bw = rng.randint(min(2, w), max(w // 2, 2) + 1)
        bh = rng.randint(min(2, h), max(h // 2, 2) + 1)
        x0 = rng.randint(1, max(w - bw, 1) + 1)
        y0 = rng.randint(1, max(h - bh, 1) + 1)
        out.append((x0, y0, min(x0 + bw, w), min(y0 + bh, h)))
    return out


def _names(names: Optional[Sequence[str]]) -> List[str]:
    names = decodable() if names is None else list(names)
    unknown = sorted(set(names) - set(decodable()))
    if not names or unknown:
        raise ValueError(f"not decodable fixtures: {unknown or names}")
    return names


def _voc_xml(path: Path, stem: str, classes: Sequence[str], rng, w: int,
             h: int) -> None:
    """A VOC-style annotation of 1-5 boxes of ``classes``."""
    rows = "".join(
        f"<object><name>{classes[rng.randint(len(classes))]}</name>"
        f"<bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax>"
        f"<ymax>{y1}</ymax></bndbox></object>"
        for x0, y0, x1, y1 in _boxes(rng, w, h))
    path.write_text(f"<annotation><filename>{stem}.jpg</filename>{rows}"
                    f"</annotation>")


def write_voc_tree(root, n_train: int = 200, n_val: int = 64,
                   seed: int = 0, names: Optional[Sequence[str]] = None,
                   files: Optional[Sequence[str]] = None) -> str:
    """``<root>/VOC2012/{JPEGImages, Annotations, ImageSets/Main}`` with
    ``n_train`` ids in train.txt and ``n_val`` in val.txt, the images
    cycling over the fixtures ``names``, or over the image ``files`` (any
    format the port reads, each placed as ``<id>.jpg``).  Returns root."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "VOC2012"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / d).mkdir(parents=True, exist_ok=True)
    if files:
        from objectdetectionpl_tpu_torch.data import native
        sources = [Path(f) for f in files]
        sizes = [native.decode_image(str(f)).shape[:2] for f in sources]
    else:
        names, shapes = _names(names), fixtures()
        sources = [TESTDATA / n for n in names]
        sizes = [shapes[n]["shape"][:2] for n in names]
    ids = [f"{i:06d}" for i in range(n_train + n_val)]
    for i, _id in enumerate(ids):
        h, w = sizes[i % len(sources)]
        _place(sources[i % len(sources)], base / "JPEGImages" / f"{_id}.jpg")
        _voc_xml(base / "Annotations" / f"{_id}.xml", _id, VOC_CLASSES, rng,
                 w, h)
    (base / "ImageSets/Main/train.txt").write_text(
        "\n".join(ids[:n_train]) + "\n")
    (base / "ImageSets/Main/val.txt").write_text(
        "\n".join(ids[n_train:]) + "\n")
    return str(root)


def write_coco_tree(root, n_train: int = 200, n_val: int = 64,
                    seed: int = 0,
                    names: Optional[Sequence[str]] = None) -> str:
    """``<root>/images/{train,val}2017`` and
    ``<root>/annotations/instances_{train,val}2017.json``, the images
    cycling over the fixtures ``names``; a few annotations use a category
    outside the 80 classes, which the parser drops.  Returns root."""
    rng = np.random.RandomState(seed)
    names, shapes = _names(names), fixtures()
    next_ann = 1
    for split, n, first in (("train", n_train, 0), ("val", n_val, n_train)):
        img_dir = Path(root) / "images" / f"{split}2017"
        img_dir.mkdir(parents=True, exist_ok=True)
        images, anns = [], []
        for k in range(n):
            i = first + k
            name = names[i % len(names)]
            h, w = shapes[name]["shape"][:2]
            file_name = f"{i:012d}.jpg"
            _place(TESTDATA / name, img_dir / file_name)
            images.append({"id": 1000 + i, "file_name": file_name,
                           "width": w, "height": h})
            for x0, y0, x1, y1 in _boxes(rng, w, h):
                cat = (COCO_CLASS_IDS[rng.randint(len(COCO_CLASSES))]
                       if rng.rand() > 0.05 else 12)    # 12: not a class
                anns.append({"id": next_ann, "image_id": 1000 + i,
                             "category_id": cat,
                             "bbox": [float(x0 - 1), float(y0 - 1),
                                      float(x1 - x0), float(y1 - y0)],
                             "area": float((x1 - x0) * (y1 - y0)),
                             "iscrowd": 0})
                next_ann += 1
        ann_dir = Path(root) / "annotations"
        ann_dir.mkdir(parents=True, exist_ok=True)
        (ann_dir / f"instances_{split}2017.json").write_text(json.dumps(
            {"images": images, "annotations": anns,
             "categories": [{"id": c, "name": n} for c, n in
                            zip(COCO_CLASS_IDS, COCO_CLASSES)]}))
    return str(root)


# BDD100K's raw categories: its classes and the ones the parser remaps or
# drops
BDD_CATEGORIES = BDD_CLASSES + ["pedestrian", "other person", "bicycle",
                                "motorcycle", "trailer", "other vehicle"]


def write_bdd100k_tree(root, n_train: int = 200, n_val: int = 64,
                       seed: int = 0,
                       names: Optional[Sequence[str]] = None,
                       videos: int = 3) -> str:
    """``<root>/images/track/{train,val}/<video>/<frame>.jpg`` and
    ``<root>/labels/box_track_20/{train,val}/<video>.json`` (Scalabel
    frames), ``n_train`` and ``n_val`` frames spread over ``videos``
    videos a split, the raw categories drawn from ``BDD_CATEGORIES``
    (every tenth frame's boxes all 'other vehicle', which the parser
    drops with the frame).  Returns root."""
    rng = np.random.RandomState(seed)
    names, shapes = _names(names), fixtures()
    for split, n, first in (("train", n_train, 0), ("val", n_val, n_train)):
        img_base = Path(root) / "images" / "track" / split
        lbl_dir = Path(root) / "labels" / "box_track_20" / split
        lbl_dir.mkdir(parents=True, exist_ok=True)
        frames: Dict[str, list] = {}
        for k in range(n):
            i = first + k
            video = f"v{k % videos:03d}"
            name = names[i % len(names)]
            h, w = shapes[name]["shape"][:2]
            (img_base / video).mkdir(parents=True, exist_ok=True)
            frame = f"{video}-{i:07d}.jpg"
            _place(TESTDATA / name, img_base / video / frame)
            labels = [{"category": ("other vehicle" if i % 10 == 9 else
                                    BDD_CATEGORIES[rng.randint(
                                        len(BDD_CATEGORIES))]),
                       "box2d": {"x1": float(x0 - 1), "y1": float(y0 - 1),
                                 "x2": float(x1), "y2": float(y1)}}
                      for x0, y0, x1, y1 in _boxes(rng, w, h)]
            frames.setdefault(video, []).append({"name": frame,
                                                 "labels": labels})
        for video, items in frames.items():
            (lbl_dir / f"{video}.json").write_text(json.dumps(items))
    return str(root)


def write_widerperson_tree(root, n_train: int = 200, n_val: int = 64,
                           seed: int = 0,
                           names: Optional[Sequence[str]] = None) -> str:
    """``<root>/Images/<id>.jpg``, ``<root>/Annotations/<id>.jpg.txt`` (a
    count line, then ``label x1 y1 x2 y2`` rows, labels 1-5) and
    ``<root>/{train,val}.txt``.  Returns root."""
    rng = np.random.RandomState(seed)
    base = Path(root)
    for d in ("Images", "Annotations"):
        (base / d).mkdir(parents=True, exist_ok=True)
    names, shapes = _names(names), fixtures()
    ids = [f"{i:06d}" for i in range(n_train + n_val)]
    for i, _id in enumerate(ids):
        name = names[i % len(names)]
        h, w = shapes[name]["shape"][:2]
        _place(TESTDATA / name, base / "Images" / f"{_id}.jpg")
        rows = [f"{rng.randint(len(WIDERPERSON_CLASSES)) + 1} {x0 - 1} "
                f"{y0 - 1} {x1} {y1}" for x0, y0, x1, y1 in _boxes(rng, w, h)]
        (base / "Annotations" / f"{_id}.jpg.txt").write_text(
            "\n".join([str(len(rows))] + rows) + "\n")
    (base / "train.txt").write_text("\n".join(ids[:n_train]) + "\n")
    (base / "val.txt").write_text("\n".join(ids[n_train:]) + "\n")
    return str(root)


def write_container_tree(root, n: int = 200, seed: int = 0,
                         names: Optional[Sequence[str]] = None) -> str:
    """``<root>/train_cdc/train_images/<stem>.jpg`` and
    ``<root>/train_cdc/train_annotations/<stem>.xml`` (VOC-style, the
    Mosquito-Container classes).  Returns root."""
    rng = np.random.RandomState(seed)
    img_dir = Path(root) / "train_cdc" / "train_images"
    ann_dir = Path(root) / "train_cdc" / "train_annotations"
    for d in (img_dir, ann_dir):
        d.mkdir(parents=True, exist_ok=True)
    names, shapes = _names(names), fixtures()
    for i in range(n):
        name, stem = names[i % len(names)], f"c{i:05d}"
        h, w = shapes[name]["shape"][:2]
        _place(TESTDATA / name, img_dir / f"{stem}.jpg")
        _voc_xml(ann_dir / f"{stem}.xml", stem, CONTAINER_CLASSES, rng, w, h)
    return str(root)


def write_asiatraffic_tree(root, n: int = 200, seed: int = 0,
                           names: Optional[Sequence[str]] = None) -> str:
    """``<root>/{JPEGImages, Annotations}`` and
    ``<root>/ImageSets/All.txt`` (VOC-style, the Asia-Traffic classes).
    Returns root."""
    rng = np.random.RandomState(seed)
    base = Path(root)
    for d in ("JPEGImages", "Annotations", "ImageSets"):
        (base / d).mkdir(parents=True, exist_ok=True)
    names, shapes = _names(names), fixtures()
    ids = [f"t{i:05d}" for i in range(n)]
    for i, _id in enumerate(ids):
        name = names[i % len(names)]
        h, w = shapes[name]["shape"][:2]
        _place(TESTDATA / name, base / "JPEGImages" / f"{_id}.jpg")
        _voc_xml(base / "Annotations" / f"{_id}.xml", _id, ASIA_CLASSES, rng,
                 w, h)
    (base / "ImageSets" / "All.txt").write_text("\n".join(ids) + "\n")
    return str(root)
