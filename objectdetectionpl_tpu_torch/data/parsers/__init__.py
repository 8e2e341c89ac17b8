"""Per-dataset annotation parsers: the port's copies of the JAX package's
VOC and COCO parsers (``objectdetectionpl_tpu/data/parsers``).

Each parser exposes ``classes`` (list[str]), ``__len__``, ``record(i) ->
(image path, boxes, labels)`` and ``__getitem__(i) -> Example`` (RGB uint8
image + top-left pixel xywh boxes + 0-based labels).  Images decode with the
port's own JPEG decoder (``data/native.py``).  BDD100K, WiderPerson,
MosquitoContainer and AsiaTraffic are not ported yet (ROADMAP A8 step 6b).
"""

from objectdetectionpl_tpu_torch.data.parsers.coco import COCOParser  # noqa: F401
from objectdetectionpl_tpu_torch.data.parsers.pascal import VOCParser  # noqa: F401
