"""The port's VOC and COCO datasets (``data/parsers``, ``data/datamodules.py``,
``data/pipeline.py::Loader``) against the JAX package, on trees made of the
committed fixture JPEGs (``tools/fixture_trees.py``).

- The parsers' ``record``s (path, boxes, labels) equal JAX's, and their
  examples' images equal JAX's ``load_image_rgb`` (cv2) bit for bit.
- ``VOCModule``'s seeded 80/20 split and ``COCOModule``'s stage rules equal
  JAX's.
- The port's Loader batches equal the JAX Loader's bit for bit (images,
  labels, boxes, mask), letterbox off and on, at 256 px, where JAX's fused
  libjpeg path decodes the 1280x720 frames at 1/2 (it scales the DCT when
  both sides are at least twice the target) and every other fixture at
  full scale (the next largest is 640x480), and so must the port's.  JAX
  takes that path only with its native library loaded (fixture
  ``jax_library``).
- Without the decoder a real dataset raises with ``build_error``.
- One ``cli.run --device cpu`` epoch on a VOC tree at the YAML's
  ``yaml_test`` caps, and one on a COCO tree with ``--set cache_dir``,
  which builds the packed caches and trains from them.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.data import datamodules as jax_dm
from objectdetectionpl_tpu.data import native as jax_native
from objectdetectionpl_tpu.data.parsers import COCOParser as JaxCOCO
from objectdetectionpl_tpu.data.parsers import VOCParser as JaxVOC
from objectdetectionpl_tpu.data.parsers import coco as jax_coco
from objectdetectionpl_tpu.data.parsers import pascal as jax_pascal
from objectdetectionpl_tpu_torch.cli import run as cli_run
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import datamodules, native
from objectdetectionpl_tpu_torch.data.parsers import COCOParser, VOCParser
from objectdetectionpl_tpu_torch.data.parsers import coco, pascal
from objectdetectionpl_tpu_torch.tools import fixture_trees
from test_torch_port_data import (_assert_same_batches, _batches,  # noqa: F401
                                  jax_library)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "config.yaml")
FULL_SCALE_PX = 256


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return fixture_trees.write_voc_tree(tmp_path_factory.mktemp("voc"),
                                        n_train=20, n_val=6, seed=1)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return fixture_trees.write_coco_tree(tmp_path_factory.mktemp("coco"),
                                         n_train=12, n_val=6, seed=2)


def test_tables_equal_jax():
    assert pascal.VOC_CLASSES == jax_pascal.VOC_CLASSES
    assert coco.COCO_CLASSES == jax_coco.COCO_CLASSES
    assert coco.COCO_CLASS_IDS == jax_coco.COCO_CLASS_IDS
    assert coco._ID_TO_CONTIGUOUS == jax_coco._ID_TO_CONTIGUOUS


def _assert_same_parser(port, ref):
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        (gp, gb, gl), (wp, wb, wl) = port.record(i), ref.record(i)
        assert gp == wp
        for g, w in ((gb, wb), (gl, wl)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    for i in range(min(len(ref), len(fixture_trees.decodable()))):
        # every fixture once
        g, w = port[i], ref[i]
        assert g.image.dtype == w.image.dtype == np.uint8
        np.testing.assert_array_equal(g.image, w.image)
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.labels, w.labels)


@pytest.mark.parametrize("split", ["train", "val"])
def test_voc_parser_equals_jax(voc_root, split):
    _assert_same_parser(VOCParser(voc_root, "2012", split),
                        JaxVOC(voc_root, "2012", split))


@pytest.mark.parametrize("mode", ["train", "val"])
def test_coco_parser_equals_jax(coco_root, mode):
    port, ref = COCOParser(coco_root, "2017", mode), JaxCOCO(coco_root,
                                                             "2017", mode)
    _assert_same_parser(port, ref)
    # annotations of a category outside the 80 classes are dropped
    with open(os.path.join(coco_root, "annotations",
                           f"instances_{mode}2017.json")) as f:
        cats = [a["category_id"] for a in json.load(f)["annotations"]]
    kept = sum(len(port.record(i)[2]) for i in range(len(port)))
    assert kept == sum(c in coco.COCO_CLASS_IDS for c in cats) < len(cats)


def test_voc_split_equals_jax(voc_root):
    for seed in (0, 3):
        kw = dict(data_module="VOC", data_root=voc_root, seed=seed)
        port = datamodules.build_datamodule(Config(**kw))
        ref = jax_dm.build_datamodule(JaxConfig(**kw))
        np.testing.assert_array_equal(port.train_idx, ref.train_idx)
        np.testing.assert_array_equal(port.val_idx, ref.val_idx)
        assert (len(port.train_idx), len(port.val_idx)) == (16, 4)
        assert port.train_parser is port.val_parser
        assert len(port.test_parser) == len(ref.test_parser) == 6
        assert port.get_class() == ref.get_class()


@pytest.mark.parametrize("stage", ["fit", "test", "all"])
def test_coco_stages_equal_jax(coco_root, stage):
    kw = dict(data_module="COCO", data_root=coco_root, stage=stage)
    port = datamodules.build_datamodule(Config(**kw))
    ref = jax_dm.build_datamodule(JaxConfig(**kw))
    for split in ("train", "val", "test"):
        p, r = (getattr(m, f"{split}_parser") for m in (port, ref))
        assert (p is None) == (r is None), split
        if r is not None:
            assert len(p) == len(r) and p.image_dir == r.image_dir
    assert port.train_idx is ref.train_idx is None
    assert port.get_class() == ref.get_class()


@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("data_module", ["VOC", "COCO"])
def test_loader_batches_equal_jax(voc_root, coco_root, jax_library,
                                  data_module, letterbox):
    for name, shape in fixture_trees.fixtures().items():
        h, w = shape["shape"][:2]       # JAX's fused path scales the frames
        scaled = h // 2 >= FULL_SCALE_PX and w // 2 >= FULL_SCALE_PX
        assert scaled == (name in fixture_trees.BDD_FRAMES), name
    root = voc_root if data_module == "VOC" else coco_root
    kw = dict(data_module=data_module, data_root=root, batch_size=3,
              img_size=FULL_SCALE_PX, max_boxes=4, letterbox=letterbox,
              seed=5, stage="all")
    port = datamodules.build_datamodule(Config(**kw))
    ref = jax_dm.build_datamodule(JaxConfig(**kw))
    assert jax_native.available()
    for split in ("train", "val", "test"):
        pl, rl = (getattr(m, f"{split}_dataloader")() for m in (port, ref))
        assert pl.decode_path == "fused" and pl.resize_path == "native"
        assert len(pl) == len(rl) > 0
        _assert_same_batches(_batches(pl, epochs=2), _batches(rl, epochs=2))


def test_loader_decodes_a_batch_in_one_call(voc_root, monkeypatch):
    calls = []
    decode_preproc_codes = native.decode_preproc_codes
    monkeypatch.setattr(native, "decode_preproc_codes",
                        lambda paths, *a, **kw: calls.append(paths) or
                        decode_preproc_codes(paths, *a, **kw))
    dm = datamodules.build_datamodule(Config(
        data_module="VOC", data_root=voc_root, batch_size=4, img_size=64))
    loader = dm.train_dataloader()
    batches = _batches(loader)
    assert len(calls) == len(batches) == 4
    assert all(len(c) == 4 for c in calls)
    assert all(c[0].endswith(".jpg") for c in calls)
    assert (loader.fused_batches, loader.parser_batches) == (4, 0)


@pytest.mark.parametrize("data_module,name", [
    ("VOC", "voc_420_q75_500x375.jpg"), ("COCO", "coco_420_q75_640x480.jpg")])
def test_tree_of_one_fixture(tmp_path, data_module, name):
    """The trees ``chip_smoke.py`` times its fits on: every image is the
    fixture of the dataset's typical size, and both packages parse them
    alike."""
    write = (fixture_trees.write_voc_tree if data_module == "VOC"
             else fixture_trees.write_coco_tree)
    root = write(tmp_path, n_train=5, n_val=3, seed=4, names=[name])
    port, ref = ((VOCParser(root, "2012", "train"), JaxVOC(root, "2012",
                                                           "train"))
                 if data_module == "VOC" else
                 (COCOParser(root, "2017", "train"), JaxCOCO(root, "2017",
                                                             "train")))
    _assert_same_parser(port, ref)
    want = (fixture_trees.TESTDATA / name).read_bytes()
    for i in range(len(port)):
        with open(port.record(i)[0], "rb") as f:
            assert f.read() == want
    with pytest.raises(ValueError, match="not decodable fixtures"):
        write(tmp_path / "bad", names=list(fixture_trees.UNSUPPORTED))


def test_loader_raises_naming_a_file_it_cannot_decode(coco_root, tmp_path,
                                                      jax_library):
    """A record that neither route reads (a broken PNG named in the COCO
    annotations, which cv2 refuses too) fails its batch with an OSError
    naming it, as JAX's ``IOError("cannot read image ...")``; a good PNG
    named ``.jpg`` sends its batch down the parser route, equal to JAX's
    batch."""
    root = tmp_path / "coco"
    shutil.copytree(coco_root, root)
    ann_file = root / "annotations" / "instances_train2017.json"
    ann = json.loads(ann_file.read_text())
    ann["images"][1]["file_name"] = "not_a_jpeg.png"
    ann_file.write_text(json.dumps(ann))
    bad = root / "images" / "train2017" / "not_a_jpeg.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(64))
    cfg = dict(data_module="COCO", data_root=str(root), batch_size=4,
               img_size=64, stage="fit")
    loader = datamodules.build_datamodule(Config(**cfg)).train_dataloader()
    with pytest.raises(native.ImageError,
                       match=f"^{re.escape(str(bad))}: PNG: "):
        _batches(loader)
    with pytest.raises(OSError, match="cannot read image"):
        _batches(jax_dm.build_datamodule(JaxConfig(**cfg)).train_dataloader())
    # the same record a good PNG under a .jpg name
    good = root / "images" / "train2017" / ann["images"][2]["file_name"]
    png = root / "images" / "train2017" / "png_named.jpg"
    png.write_bytes(cv2_png(good))
    ann["images"][1]["file_name"] = "png_named.jpg"
    ann_file.write_text(json.dumps(ann))
    port = datamodules.build_datamodule(Config(**cfg)).train_dataloader()
    ref = jax_dm.build_datamodule(JaxConfig(**cfg)).train_dataloader()
    _assert_same_batches(_batches(port), _batches(ref))
    assert port.parser_batches == 1 and port.fused_batches == len(port) - 1


def cv2_png(path) -> bytes:
    """The image at ``path`` re-encoded as a PNG by cv2."""
    import cv2
    ok, buf = cv2.imencode(".png", cv2.imread(str(path)))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("data_module", ["VOC", "COCO"])
def test_real_dataset_needs_the_decoder(voc_root, coco_root, monkeypatch,
                                        data_module):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    monkeypatch.setattr(native, "build_error", "OSError: no g++")
    root = voc_root if data_module == "VOC" else coco_root
    with pytest.raises(RuntimeError, match="could not be built: OSError: "
                                           "no g\\+\\+"):
        datamodules.build_datamodule(Config(data_module=data_module,
                                            data_root=root))
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        native.decode_one(str(fixture_trees.TESTDATA /
                              fixture_trees.decodable()[0]))


def test_cli_run_voc_epoch(voc_root, tmp_path):
    """``cli.run`` on the YAML (its ``yaml_test`` caps: 128 px, B=2,
    accumulation 2, 4 train, 2 val and 2 test batches), one epoch of
    YOLOv5s on the VOC tree: a finite mAP table over VOC's classes and a
    checkpoint."""
    results = cli_run.main([YAML, "--device", "cpu",
                            "--set", "data_module", "VOC",
                            "--set", "data_root", voc_root,
                            "--set", "model_name", "YOLOv5",
                            "--set", "max_epochs", "1",
                            "--set", "log_dir", str(tmp_path)])
    for k in ("mAP", "precision", "recall", "f1"):
        assert np.isfinite(results[k]) and 0.0 <= results[k] <= 1.0
    run_dir = tmp_path / "VOC" / "YOLOv5"
    assert (run_dir / "checkpoints" / "0" / "state.pt").exists()
    rows = (run_dir / "metrics.jsonl").read_text()
    assert "Loss/loss/Train" in rows and "val_loss" in rows


def test_cli_run_coco_epoch_from_the_cache(coco_root, tmp_path, capsys):
    """``cli.run --set cache_dir``: the CLI builds one packed cache per
    parser (train, val, and the test stage's own val parser), valid for
    the run's geometry, then fits, validates and tests YOLOv5s from uint8
    batches: a finite mAP table over COCO's classes."""
    from objectdetectionpl_tpu_torch.data import cache
    cache_dir = tmp_path / "cache"
    results = cli_run.main([YAML, "--device", "cpu",
                            "--set", "data_module", "COCO",
                            "--set", "data_root", coco_root,
                            "--set", "model_name", "YOLOv5",
                            "--set", "cache_dir", str(cache_dir),
                            "--set", "max_epochs", "1",
                            "--set", "log_dir", str(tmp_path / "logs")])
    for k in ("mAP", "precision", "recall", "f1"):
        assert np.isfinite(results[k]) and 0.0 <= results[k] <= 1.0
    names = sorted(os.listdir(cache_dir))
    assert names == ["COCO_test_128px", "COCO_train_128px", "COCO_val_128px"]
    for name, n in zip(names, (6, 12, 6)):
        assert cache.cache_valid(str(cache_dir / name), n, 128, False)
    rows = (tmp_path / "logs" / "COCO" / "YOLOv5" /
            "metrics.jsonl").read_text()
    assert "Loss/loss/Train" in rows and "val_loss" in rows
