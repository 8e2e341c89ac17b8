"""DataModules: per-dataset split semantics + loader construction.

The port of ``objectdetectionpl_tpu/data/datamodules.py``:

- Synthetic: train / val / test parsers of ``synthetic_size``,
  ``max(synthetic_size // 4, 4)`` and the same, seeded 1, 2 and 3;
- VOC: a seeded 80/20 random split of the 'train' list; test = the 'val'
  list (``voc_year`` in the config's extra keys, default 2012);
- COCO: train{year} / val{year} by file; test = val (``coco_year``,
  default 2017).

The real datasets decode with the port's JPEG decoder and raise, naming
``native.jpeg_build_error``, where it cannot be built.  BDD100K,
WiderPerson, MosquitoContainer and AsiaTraffic raise naming ROADMAP A8
step 6b.
"""

from __future__ import annotations

from typing import List, Optional

from objectdetectionpl_tpu_torch.data import native, synthetic
from objectdetectionpl_tpu_torch.data.pipeline import (Loader,
                                                       random_split_indices)

NOT_PORTED = ("BDD100K", "WiderPerson", "MosquitoContainer", "AsiaTraffic")


def _need_decoder(name: str) -> None:
    if not native.jpeg_available():
        raise RuntimeError(f"data_module {name!r} needs the JPEG decoder "
                           f"(csrc/jpeg_decode.cc), which could not be "
                           f"built: {native.jpeg_build_error}")


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

    def setup(self, stage: str = "fit"):
        raise NotImplementedError

    def get_class(self) -> List[str]:
        raise NotImplementedError

    def _loader(self, parser, shuffle, indices=None, limit=None,
                batch_size: Optional[int] = None,
                sharded: bool = False) -> Loader:
        cfg = self.cfg
        if sharded:
            from objectdetectionpl_tpu_torch.parallel import data_shard
            num_shards, shard_id = data_shard()
        else:
            num_shards, shard_id = 1, 0
        return Loader(parser, cfg.effective_img_size,
                      batch_size or cfg.batch_size, cfg.max_boxes,
                      shuffle=shuffle, seed=cfg.seed, indices=indices,
                      limit_batches=limit, letterbox=cfg.letterbox,
                      num_shards=num_shards, shard_id=shard_id,
                      cache_dir=cfg.cache_dir or None)

    def train_dataloader(self) -> Loader:
        # train batches are process-sharded; val/test run the full set in
        # every process so their metrics need no cross-process reduction
        return self._loader(self.train_parser, True, self.train_idx,
                            self.cfg.limit_train_batches, sharded=True)

    def val_dataloader(self) -> Loader:
        return self._loader(self.val_parser, False, self.val_idx,
                            self.cfg.limit_val_batches)

    def test_dataloader(self) -> Loader:
        return self._loader(self.test_parser, False, None,
                            self.cfg.limit_test_batches)


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


DATAMODULES = {"Synthetic": SyntheticModule, "VOC": VOCModule,
               "COCO": COCOModule}


def build_datamodule(cfg) -> DataModule:
    """String dispatch on ``cfg.data_module``, then ``setup(cfg.stage)``."""
    if cfg.data_module in NOT_PORTED:
        raise NotImplementedError(f"data_module {cfg.data_module!r} is not "
                                  f"ported yet (ROADMAP A8 step 6b)")
    try:
        dm = DATAMODULES[cfg.data_module](cfg)
    except KeyError:
        raise ValueError(f"unknown data_module {cfg.data_module!r}") from None
    dm.setup(cfg.stage)
    return dm
