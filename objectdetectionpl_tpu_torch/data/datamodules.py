"""DataModules: per-dataset split semantics + loader construction.

The port of ``objectdetectionpl_tpu/data/datamodules.py``:

- Synthetic: train / val / test parsers of ``synthetic_size``,
  ``max(synthetic_size // 4, 4)`` and the same, seeded 1, 2 and 3;
- VOC: a seeded 80/20 random split of the 'train' list; test = the 'val'
  list (``voc_year`` in the config's extra keys, default 2012);
- COCO: train{year} / val{year} by file; test = val (``coco_year``,
  default 2017);
- BDD100K: train/ and val/ directories; test = val;
- WiderPerson: train / val id lists; test = val;
- MosquitoContainer, AsiaTraffic: a seeded 80/20 random split of the full
  set; test = the full set.

The real datasets decode with the port's JPEG decoder and raise, naming
``native.build_error``, where it cannot be built.  With ``cache_dir``
each loader reads the packed cache of its parser (``data/cache.py``),
built once on first use under ``<cache_dir>/<dataset>_<role>_<S>px``
(``_lb`` with letterbox), the role being the first split that asked for
that parser, so a train/val split of one parser shares one cache.
Under a process group the train loader reads the rank's shard
(``parallel/distributed.py::data_shard``), while val and test run the
whole set on every rank, so their metrics need no reduction; rank 0
builds a cache while the others wait.
"""

from __future__ import annotations

import os
from typing import List, Optional

from objectdetectionpl_tpu_torch.data import cache as cache_lib
from objectdetectionpl_tpu_torch.data import native, synthetic
from objectdetectionpl_tpu_torch.data.pipeline import (Loader,
                                                       random_split_indices)
from objectdetectionpl_tpu_torch.parallel import distributed


def _need_decoder(name: str) -> None:
    if not native.available():
        raise RuntimeError(f"data_module {name!r} needs the JPEG decoder "
                           f"(csrc/jpeg_decode.cc), which could not be "
                           f"built: {native.build_error}")


class DataModule:
    """Holds train/val/test parsers + split indices; builds Loaders."""

    name = "base"

    def __init__(self, cfg):
        self.cfg = cfg
        self.train_parser = None
        self.val_parser = None
        self.test_parser = None
        self.train_idx = None
        self.val_idx = None
        self._cache_roles = {}          # id(parser) -> its cache's role

    def setup(self, stage: str = "fit"):
        raise NotImplementedError

    def get_class(self) -> List[str]:
        raise NotImplementedError

    def _loader(self, parser, shuffle, indices=None, limit=None,
                batch_size: Optional[int] = None, sharded: bool = False,
                split: str = "train") -> Loader:
        cfg = self.cfg
        num_shards, shard_id = (distributed.data_shard() if sharded
                                else (1, 0))
        cache_dir = None
        if cfg.cache_dir:
            S = cfg.effective_img_size
            role = self._cache_roles.setdefault(id(parser), split)
            cache_dir = os.path.join(
                cfg.cache_dir,
                f"{self.name}_{role}_{S}px" + ("_lb" if cfg.letterbox else ""))
            # one rank builds, the others wait and read its cache
            if distributed.process_index() == 0:
                cache_lib.build_packed_cache(parser, S, cache_dir,
                                             letterbox=cfg.letterbox)
            distributed.barrier()
        return Loader(parser, cfg.effective_img_size,
                      batch_size or cfg.batch_size, cfg.max_boxes,
                      shuffle=shuffle, seed=cfg.seed, indices=indices,
                      limit_batches=limit, letterbox=cfg.letterbox,
                      num_shards=num_shards, shard_id=shard_id,
                      cache_dir=cache_dir)

    def train_dataloader(self) -> Loader:
        # train batches are process-sharded; val/test run the full set in
        # every process so their metrics need no cross-process reduction
        return self._loader(self.train_parser, True, self.train_idx,
                            self.cfg.limit_train_batches, sharded=True,
                            split="train")

    def val_dataloader(self) -> Loader:
        return self._loader(self.val_parser, False, self.val_idx,
                            self.cfg.limit_val_batches, split="val")

    def test_dataloader(self) -> Loader:
        return self._loader(self.test_parser, False, None,
                            self.cfg.limit_test_batches, split="test")


class SyntheticModule(DataModule):
    name = "Synthetic"

    def setup(self, stage: str = "fit"):
        size = self.cfg.synthetic_size
        self.train_parser = synthetic.SyntheticParser(size, seed=1)
        self.val_parser = synthetic.SyntheticParser(max(size // 4, 4), seed=2)
        self.test_parser = synthetic.SyntheticParser(max(size // 4, 4), seed=3)

    def get_class(self):
        return synthetic.SYNTHETIC_CLASSES


class VOCModule(DataModule):
    name = "VOC"

    def setup(self, stage: str = "fit"):
        from objectdetectionpl_tpu_torch.data.parsers import VOCParser
        _need_decoder(self.name)
        root = self.cfg.data_root
        year = str(self.cfg.extra.get("voc_year", "2012"))
        train = VOCParser(root, year, "train")
        self.train_idx, self.val_idx = random_split_indices(
            len(train), 0.8, self.cfg.seed)
        self.train_parser = self.val_parser = train
        self.test_parser = VOCParser(root, year, "val")

    def get_class(self):
        from objectdetectionpl_tpu_torch.data.parsers.pascal import \
            VOC_CLASSES
        return VOC_CLASSES


class COCOModule(DataModule):
    name = "COCO"

    def setup(self, stage: str = "fit"):
        from objectdetectionpl_tpu_torch.data.parsers import COCOParser
        _need_decoder(self.name)
        root = self.cfg.data_root
        year = str(self.cfg.extra.get("coco_year", "2017"))
        if stage in ("fit", "all"):
            self.train_parser = COCOParser(root, year, "train")
            self.val_parser = COCOParser(root, year, "val")
        if stage in ("test", "all") or self.val_parser is None:
            self.test_parser = COCOParser(root, year, "val")

    def get_class(self):
        from objectdetectionpl_tpu_torch.data.parsers.coco import \
            COCO_CLASSES
        return COCO_CLASSES


class BDD100KModule(DataModule):
    name = "BDD100K"

    def setup(self, stage: str = "fit"):
        from objectdetectionpl_tpu_torch.data.parsers import BDD100KParser
        _need_decoder(self.name)
        root = self.cfg.data_root
        if stage in ("fit", "all"):
            self.train_parser = BDD100KParser(root, "train")
            self.val_parser = BDD100KParser(root, "val")
        if stage in ("test", "all") or self.val_parser is None:
            self.test_parser = BDD100KParser(root, "val")

    def get_class(self):
        from objectdetectionpl_tpu_torch.data.parsers.bdd100k import \
            BDD_CLASSES
        return BDD_CLASSES


class WiderPersonModule(DataModule):
    name = "WiderPerson"

    def setup(self, stage: str = "fit"):
        from objectdetectionpl_tpu_torch.data.parsers import \
            WiderPersonParser
        _need_decoder(self.name)
        root = self.cfg.data_root
        self.train_parser = WiderPersonParser(root, "train")
        self.val_parser = WiderPersonParser(root, "val")
        self.test_parser = WiderPersonParser(root, "val")

    def get_class(self):
        from objectdetectionpl_tpu_torch.data.parsers.widerperson import \
            WIDERPERSON_CLASSES
        return WIDERPERSON_CLASSES


class MosquitoModule(DataModule):
    name = "MosquitoContainer"

    def setup(self, stage: str = "fit"):
        from objectdetectionpl_tpu_torch.data.parsers import ContainerParser
        _need_decoder(self.name)
        full = ContainerParser(self.cfg.data_root)
        self.train_idx, self.val_idx = random_split_indices(
            len(full), 0.8, self.cfg.seed)
        self.train_parser = self.val_parser = full
        self.test_parser = full

    def get_class(self):
        from objectdetectionpl_tpu_torch.data.parsers.container import \
            CONTAINER_CLASSES
        return CONTAINER_CLASSES


class AsiaModule(DataModule):
    name = "AsiaTraffic"

    def setup(self, stage: str = "fit"):
        from objectdetectionpl_tpu_torch.data.parsers import \
            AsiaTrafficParser
        _need_decoder(self.name)
        full = AsiaTrafficParser(self.cfg.data_root)
        self.train_idx, self.val_idx = random_split_indices(
            len(full), 0.8, self.cfg.seed)
        self.train_parser = self.val_parser = full
        self.test_parser = full

    def get_class(self):
        from objectdetectionpl_tpu_torch.data.parsers.asiatraffic import \
            ASIA_CLASSES
        return ASIA_CLASSES


DATAMODULES = {
    "Synthetic": SyntheticModule,
    "VOC": VOCModule,
    "COCO": COCOModule,
    "BDD100K": BDD100KModule,
    "WiderPerson": WiderPersonModule,
    "MosquitoContainer": MosquitoModule,
    "AsiaTraffic": AsiaModule,
}


def build_datamodule(cfg) -> DataModule:
    """String dispatch on ``cfg.data_module``, then ``setup(cfg.stage)``."""
    try:
        dm = DATAMODULES[cfg.data_module](cfg)
    except KeyError:
        raise ValueError(f"unknown data_module {cfg.data_module!r}") from None
    dm.setup(cfg.stage)
    return dm
