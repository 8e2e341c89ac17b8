"""The port's BDD100K, WiderPerson, Mosquito-Container and Asia-Traffic
parsers (``data/parsers``) and DataModules (``data/datamodules.py``)
against the JAX package's.

- On the hand-made fixtures of ``tests/test_data.py`` (the same files,
  drawn by its helpers from the same seed, and the same expectations) and
  on trees of the committed fixture JPEGs (``tools/fixture_trees.py``, 10
  images cycling over the decodable fixtures): records (path, boxes,
  labels) equal, and the examples' images equal JAX's ``load_image_rgb``
  (cv2) bit for bit.
- The DataModules' splits, stages and class lists equal JAX's.
- The Loader's batches, one fused decode-and-resize call a batch, equal
  the JAX Loader's fused libjpeg path bit for bit at 256 px (where JAX
  decodes the 1280x720 frames at 1/2, the others at full scale), letterbox
  off and on, over the
  train, val and test loaders (fixture ``jax_library``).
"""

import json

import numpy as np
import pytest

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.data import datamodules as jax_dm
from objectdetectionpl_tpu.data import parsers as jax_parsers
from objectdetectionpl_tpu.data.parsers import asiatraffic as jax_asia
from objectdetectionpl_tpu.data.parsers import bdd100k as jax_bdd
from objectdetectionpl_tpu.data.parsers import container as jax_container
from objectdetectionpl_tpu.data.parsers import widerperson as jax_wider
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import datamodules, parsers
from objectdetectionpl_tpu_torch.data.parsers import (asiatraffic, bdd100k,
                                                      container, widerperson)
from objectdetectionpl_tpu_torch.tools import fixture_trees
from test_data import _voc_xml, _write_jpg
from test_torch_port_data import (_assert_same_batches, _batches,  # noqa: F401
                                  jax_library)
from test_torch_port_datasets import FULL_SCALE_PX, _assert_same_parser

MODULES = ("BDD100K", "WiderPerson", "MosquitoContainer", "AsiaTraffic")
PARSER = {"BDD100K": "BDD100KParser", "WiderPerson": "WiderPersonParser",
          "MosquitoContainer": "ContainerParser",
          "AsiaTraffic": "AsiaTrafficParser"}


def test_tables_equal_jax():
    assert bdd100k.BDD_CLASSES == jax_bdd.BDD_CLASSES
    assert bdd100k._REMAP == jax_bdd._REMAP
    assert widerperson.WIDERPERSON_CLASSES == jax_wider.WIDERPERSON_CLASSES
    assert container.CONTAINER_CLASSES == jax_container.CONTAINER_CLASSES
    assert asiatraffic.ASIA_CLASSES == jax_asia.ASIA_CLASSES
    assert set(datamodules.DATAMODULES) == set(jax_dm.DATAMODULES)


def _pair(name, *args):
    return (getattr(parsers, PARSER[name])(*args),
            getattr(jax_parsers, PARSER[name])(*args))


# --- the fixtures of tests/test_data.py -------------------------------------


def _widerperson_fixture(root, rng):
    (root / "Images").mkdir()
    (root / "Annotations").mkdir()
    _write_jpg(str(root / "Images" / "x.jpg"), rng)
    (root / "Annotations" / "x.jpg.txt").write_text(
        "2\n1 5 6 25 30\n3 0 0 10 10\n")
    (root / "train.txt").write_text("x\n")
    (root / "test.txt").write_text("x\n")


def _bdd100k_fixture(root, rng):
    img_dir = root / "images" / "track" / "train" / "vid1"
    lbl_dir = root / "labels" / "box_track_20" / "train"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    _write_jpg(str(img_dir / "f0.jpg"), rng)
    frames = [{"name": "f0.jpg", "labels": [
        {"category": "pedestrian",
         "box2d": {"x1": 1, "y1": 2, "x2": 11, "y2": 22}},
        {"category": "other vehicle",
         "box2d": {"x1": 0, "y1": 0, "x2": 5, "y2": 5}},
        {"category": "trailer",
         "box2d": {"x1": 3, "y1": 3, "x2": 9, "y2": 9}}]}]
    (lbl_dir / "vid1.json").write_text(json.dumps(frames))


def _container_fixture(root, rng):
    img_dir = root / "train_cdc" / "train_images"
    ann_dir = root / "train_cdc" / "train_annotations"
    img_dir.mkdir(parents=True)
    ann_dir.mkdir(parents=True)
    for i in range(2):
        _write_jpg(str(img_dir / f"c{i}.jpg"), rng)
        _voc_xml(str(ann_dir / f"c{i}.xml"),
                 [(6, 8, 30, 28, i), (0, 0, 0, 0, 1)],
                 container.CONTAINER_CLASSES)


def _asiatraffic_fixture(root, rng):
    for d in ("JPEGImages", "Annotations", "ImageSets"):
        (root / d).mkdir()
    ids = ["t0", "t1", "t2"]
    for i, _id in enumerate(ids):
        _write_jpg(str(root / "JPEGImages" / f"{_id}.jpg"), rng)
        _voc_xml(str(root / "Annotations" / f"{_id}.xml"),
                 [(4, 5, 20, 22, i % 4)], asiatraffic.ASIA_CLASSES)
    (root / "ImageSets" / "All.txt").write_text("\n".join(ids))


def test_widerperson_fixture(tmp_path, rng):
    _widerperson_fixture(tmp_path, rng)
    port, ref = _pair("WiderPerson", str(tmp_path), "train")
    _assert_same_parser(port, ref)
    ex = port[0]
    assert list(ex.labels) == [0, 2]
    np.testing.assert_allclose(ex.boxes[0], [5, 6, 20, 24])
    # the test split has no annotations
    port, ref = _pair("WiderPerson", str(tmp_path), "test")
    _assert_same_parser(port, ref)
    assert port.record(0)[1].shape == (0, 4)


def test_bdd100k_fixture(tmp_path, rng):
    _bdd100k_fixture(tmp_path, rng)
    port, ref = _pair("BDD100K", str(tmp_path), "train")
    _assert_same_parser(port, ref)
    ex = port[0]
    assert list(ex.labels) == [4, 9]      # person, truck; 'other vehicle'
    np.testing.assert_allclose(ex.boxes[0], [1, 2, 10, 20])


def test_container_fixture(tmp_path, rng):
    _container_fixture(tmp_path, rng)
    port, ref = _pair("MosquitoContainer", str(tmp_path))
    _assert_same_parser(port, ref)
    assert len(port) == 2
    ex = port[0]
    assert len(ex.labels) == 1 and ex.labels[0] == 0
    np.testing.assert_allclose(ex.boxes[0], [5, 7, 24, 20])


def test_asiatraffic_fixture(tmp_path, rng):
    _asiatraffic_fixture(tmp_path, rng)
    port, ref = _pair("AsiaTraffic", str(tmp_path))
    _assert_same_parser(port, ref)
    assert len(port) == 3
    np.testing.assert_allclose(port[1].boxes[0], [3, 4, 16, 17])
    assert port[1].labels[0] == 1


# --- trees of the committed fixture JPEGs ----------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    return {
        "BDD100K": fixture_trees.write_bdd100k_tree(base / "bdd", 6, 4,
                                                    seed=1),
        "WiderPerson": fixture_trees.write_widerperson_tree(base / "wider",
                                                            7, 3, seed=2),
        "MosquitoContainer": fixture_trees.write_container_tree(
            base / "container", 10, seed=3),
        "AsiaTraffic": fixture_trees.write_asiatraffic_tree(base / "asia", 10,
                                                            seed=4)}


@pytest.mark.parametrize("name,split", [
    ("BDD100K", "train"), ("BDD100K", "val"), ("WiderPerson", "train"),
    ("WiderPerson", "val"), ("MosquitoContainer", None),
    ("AsiaTraffic", None)])
def test_parser_on_a_tree_equals_jax(trees, name, split):
    args = (trees[name],) + ((split,) if split else ())
    port, ref = _pair(name, *args)
    _assert_same_parser(port, ref)
    if name == "BDD100K":        # the frames of only 'other vehicle' drop
        n, first = (6, 0) if split == "train" else (4, 6)
        assert len(port) == n - sum((first + k) % 10 == 9 for k in range(n))


@pytest.mark.parametrize("stage", ["fit", "test", "all"])
@pytest.mark.parametrize("name", MODULES)
def test_datamodule_equals_jax(trees, name, stage):
    kw = dict(data_module=name, data_root=trees[name], stage=stage, seed=3)
    port = datamodules.build_datamodule(Config(**kw))
    ref = jax_dm.build_datamodule(JaxConfig(**kw))
    assert port.get_class() == ref.get_class()
    for split in ("train", "val", "test"):
        p, r = (getattr(m, f"{split}_parser") for m in (port, ref))
        assert (p is None) == (r is None), split
        if r is not None:
            assert type(p).__name__ == type(r).__name__
            assert [p.record(i)[0] for i in range(len(p))] == [
                r.record(i)[0] for i in range(len(r))]
    for idx in ("train_idx", "val_idx"):
        p, r = getattr(port, idx), getattr(ref, idx)
        assert (p is None) == (r is None)
        if r is not None:
            np.testing.assert_array_equal(p, r)
    if name in ("MosquitoContainer", "AsiaTraffic"):
        assert (len(port.train_idx), len(port.val_idx)) == (8, 2)
        assert port.train_parser is port.val_parser is port.test_parser


@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("name", MODULES)
def test_loader_batches_equal_jax(trees, jax_library, name, letterbox):
    kw = dict(data_module=name, data_root=trees[name], batch_size=2,
              img_size=FULL_SCALE_PX, max_boxes=4, letterbox=letterbox,
              seed=6, stage="all")
    port = datamodules.build_datamodule(Config(**kw))
    ref = jax_dm.build_datamodule(JaxConfig(**kw))
    for split in ("train", "val", "test"):
        pl, rl = (getattr(m, f"{split}_dataloader")() for m in (port, ref))
        assert pl.decode_path == "fused"
        assert len(pl) == len(rl) > 0
        _assert_same_batches(_batches(pl), _batches(rl))
