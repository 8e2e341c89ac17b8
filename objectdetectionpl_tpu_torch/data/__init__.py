"""Data: parsed examples -> fixed-shape host batches (``pipeline.Loader``)
-> the batch augmentation on the device (``augment.augment_batch``).

Targets are center-form xywh normalized to [0, 1], padded to ``max_boxes``
with a validity mask, as in the JAX package.  All seven DataModules are
ported, the real datasets on the port's own JPEG decoder, with the packed
uint8 cache (``cache.py``) as an option.
"""

from objectdetectionpl_tpu_torch.data.datamodules import (  # noqa: F401
    DATAMODULES, build_datamodule)
