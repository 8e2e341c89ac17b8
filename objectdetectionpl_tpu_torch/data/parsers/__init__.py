"""Per-dataset annotation parsers: the port's copies of the JAX package's
parsers (``objectdetectionpl_tpu/data/parsers``).

Each parser exposes ``classes`` (list[str]), ``__len__``, ``record(i) ->
(image path, boxes, labels)`` and ``__getitem__(i) -> Example`` (RGB uint8
image + top-left pixel xywh boxes + 0-based labels).  Images decode with the
port's own JPEG decoder (``data/native.py``); the Loader decodes and
resizes a batch of ``record`` paths with one call.
"""

from objectdetectionpl_tpu_torch.data.parsers.asiatraffic import AsiaTrafficParser  # noqa: F401
from objectdetectionpl_tpu_torch.data.parsers.bdd100k import BDD100KParser  # noqa: F401
from objectdetectionpl_tpu_torch.data.parsers.coco import COCOParser  # noqa: F401
from objectdetectionpl_tpu_torch.data.parsers.container import ContainerParser  # noqa: F401
from objectdetectionpl_tpu_torch.data.parsers.pascal import VOCParser  # noqa: F401
from objectdetectionpl_tpu_torch.data.parsers.widerperson import WiderPersonParser  # noqa: F401
