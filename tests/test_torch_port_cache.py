"""The port's packed cache (``data/cache.py``), its uint8 resize and the
Trainer's uint8 batch path, against cv2 and the JAX package.

- The uint8 resize, cv2's INTER_LINEAR on 8-bit images: the library's
  (``native.preproc_batch(..., u8=True)``) and its numpy plain version
  (``pipeline.resize_u8``, ``letterbox_u8``) against ``cv2.resize`` and
  the JAX package's ``_resize_letterbox``, bit for bit, on random images
  over eleven sizes down and up (640x480 -> 213 letterboxes to 213x160).
- ``build_packed_cache`` against JAX's on the same trees: ``images.u8``
  byte for byte, ``targets.npz`` (boxes within 1e-6) and ``meta.json``
  equal but for the port's ``"exif": true``, letterbox off and on; a JPEG
  tree (the fused decode into the memmap) and Synthetic (the library, and
  the numpy resize without it).
- Cached Loader batches against JAX's cached Loader, through the
  DataModules with ``cache_dir`` (the same cache directories, the same
  shuffle seed, two epochs): bit for bit; the port's Loader also reads the
  cache JAX built.
- The Trainer's uint8 batch against the same batch in float32 (u8 / 255):
  the device batch, augmented or not, and the eval losses, bit for bit.
- ``PinnedRing``'s slots and waits, with fake pinning and events.

Images 37-1920 px for the resize, trees of at most 10 JPEGs at 128 px.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.data import cache as jax_cache
from objectdetectionpl_tpu.data import datamodules as jax_dm
from objectdetectionpl_tpu.data import synthetic as jax_syn
from objectdetectionpl_tpu.data.pipeline import _resize_letterbox
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import (cache, datamodules, native,
                                              pipeline, synthetic)
from objectdetectionpl_tpu_torch.data.parsers import COCOParser, VOCParser
from objectdetectionpl_tpu_torch.data.types import Batch
from objectdetectionpl_tpu_torch.tools import fixture_trees
from objectdetectionpl_tpu_torch.train import loop
from test_torch_port_data import _assert_same_batches, _batches

IMG = 128
# (source H, W) -> S: VOC and COCO sizes to the YOLO sizes, odd, tiny and
# large sources, exact halving (cv2's area path), portrait; 640x480 -> 213
# letterboxes to a 213x160 rectangle
RESIZE_CASES = {
    "500x375->64": ((375, 500), 64), "500x375->416": ((375, 500), 416),
    "640x480->640": ((480, 640), 640), "640x480->213": ((480, 640), 213),
    "37x53->64": ((53, 37), 64), "100x100->50": ((100, 100), 50),
    "333x251->640": ((251, 333), 640), "1920x1080->640": ((1080, 1920), 640),
    "400x600->640": ((600, 400), 640), "5x3->640": ((3, 5), 640),
    "1280x720->416": ((720, 1280), 416)}


@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("case", list(RESIZE_CASES))
def test_resize_u8_equals_cv2(case, letterbox):
    (h, w), S = RESIZE_CASES[case]
    img = np.random.RandomState(h * 7 + w).randint(
        0, 256, (h, w, 3)).astype(np.uint8)
    if letterbox:
        want, scale, px, py = _resize_letterbox(img, S)
        canvas, s, gx, gy = pipeline.letterbox_u8(img, S)
        assert (s, gx, gy) == (scale, px, py)
        np.testing.assert_array_equal(canvas, want)
        want_meta = (np.float32(scale), px, py)
    else:
        want = cv2.resize(img, (S, S), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(pipeline.resize_u8(img, S, S), want)
        want_meta = (1.0, 0.0, 0.0)
    got, scales, pad_xs, pad_ys = native.preproc_batch([img], S, letterbox,
                                                       u8=True)
    assert got.dtype == np.uint8 and got.shape == (1, S, S, 3)
    np.testing.assert_array_equal(got[0], want)
    assert (scales[0], pad_xs[0], pad_ys[0]) == want_meta
    plain, *meta = pipeline.numpy_preproc_u8([img], S, letterbox)
    np.testing.assert_array_equal(plain, got)
    assert tuple(m[0] for m in meta) == want_meta


def test_resize_u8_rectangle_equals_cv2():
    """The 213x160 rectangle that 640x480 -> 213 letterboxes to."""
    img = np.random.RandomState(2).randint(0, 256, (480, 640, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        pipeline.resize_u8(img, 213, 160),
        cv2.resize(img, (213, 160), interpolation=cv2.INTER_LINEAR))
    got = native.preproc_batch([img], 213, True, u8=True)[0][0]
    np.testing.assert_array_equal(got[26:186], pipeline.resize_u8(img, 213,
                                                                  160))
    assert (got[:26] == 114).all() and (got[186:] == 114).all()


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return fixture_trees.write_coco_tree(tmp_path_factory.mktemp("coco"),
                                         n_train=7, n_val=3, seed=3)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return fixture_trees.write_voc_tree(tmp_path_factory.mktemp("voc"),
                                        n_train=8, n_val=2, seed=5)


def _assert_same_cache(got_dir, want_dir):
    with open(os.path.join(got_dir, "images.u8"), "rb") as g, \
            open(os.path.join(want_dir, "images.u8"), "rb") as w:
        assert g.read() == w.read(), "images.u8"
    # JAX's keys and values, and the port's mark of turned images
    with open(os.path.join(got_dir, "meta.json")) as g, \
            open(os.path.join(want_dir, "meta.json")) as w:
        assert json.load(g) == {**json.load(w), "exif": True}
    got = np.load(os.path.join(got_dir, "targets.npz"))
    want = np.load(os.path.join(want_dir, "targets.npz"))
    assert sorted(got.files) == sorted(want.files) == ["boxes", "labels",
                                                       "offsets"]
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["offsets"], want["offsets"])


@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("data_module", ["VOC", "COCO"])
def test_cache_of_a_jpeg_tree_equals_jax(tmp_path, voc_root, coco_root,
                                         data_module, letterbox):
    from objectdetectionpl_tpu.data.parsers import COCOParser as JaxCOCO
    from objectdetectionpl_tpu.data.parsers import VOCParser as JaxVOC
    port, ref = ((VOCParser(voc_root, "2012", "train"),
                  JaxVOC(voc_root, "2012", "train"))
                 if data_module == "VOC" else
                 (COCOParser(coco_root, "2017", "train"),
                  JaxCOCO(coco_root, "2017", "train")))
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    assert cache.build_packed_cache(port, IMG, got, letterbox) == got
    jax_cache.build_packed_cache(ref, IMG, want, letterbox=letterbox)
    _assert_same_cache(got, want)
    assert cache.cache_valid(got, len(port), IMG, letterbox)
    assert not cache.cache_valid(got, len(port), IMG, not letterbox)
    # rebuilding is a no-op
    mtime = os.path.getmtime(os.path.join(got, "images.u8"))
    cache.build_packed_cache(port, IMG, got, letterbox)
    assert os.path.getmtime(os.path.join(got, "images.u8")) == mtime


@pytest.mark.parametrize("resize", ["library", "numpy"])
@pytest.mark.parametrize("letterbox", [False, True])
def test_cache_of_synthetic_equals_jax(tmp_path, monkeypatch, resize,
                                       letterbox):
    """Synthetic images (given by the parser) through the library's uint8
    resize and, without the library, through ``pipeline.resize_u8``."""
    port = synthetic.SyntheticParser(6, img_hw=96, seed=2)
    ref = jax_syn.SyntheticParser(6, img_hw=96, seed=2)
    if resize == "numpy":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load_failed", True)
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    cache.build_packed_cache(port, 64, got, letterbox)
    jax_cache.build_packed_cache(ref, 64, want, letterbox=letterbox)
    _assert_same_cache(got, want)
    assert len(cache.PackedCache(got)) == len(port)


@pytest.mark.parametrize("letterbox", [False, True])
def test_cached_loaders_equal_jax(tmp_path, coco_root, letterbox):
    """``cache_dir`` through the DataModules: the same cache directories
    (one per parser, keyed by its first role), each equal to JAX's, and
    the same batches over two shuffled epochs."""
    kw = dict(data_module="COCO", data_root=coco_root, batch_size=2,
              img_size=IMG, max_boxes=4, letterbox=letterbox, seed=7,
              stage="all")
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    port = datamodules.build_datamodule(Config(**kw, cache_dir=str(got_dir)))
    ref = jax_dm.build_datamodule(JaxConfig(**kw, cache_dir=str(want_dir)))
    for split in ("train", "val", "test"):
        pl, rl = (getattr(m, f"{split}_dataloader")() for m in (port, ref))
        assert pl.decode_path == "cache" and rl.cache is not None
        assert pl.read_ahead_batches == rl.read_ahead_batches == 32
        got = _batches(pl, epochs=2)
        assert all(b.images.dtype == np.uint8 for b in got)
        _assert_same_batches(got, _batches(rl, epochs=2))
    names = sorted(os.listdir(want_dir))
    suffix = "_lb" if letterbox else ""
    assert names == sorted(os.listdir(got_dir)) == [
        f"COCO_{role}_{IMG}px{suffix}" for role in ("test", "train", "val")]
    for name in names:
        _assert_same_cache(got_dir / name, want_dir / name)
    # the port's Loader reads the cache that JAX built, and willneed is safe
    loader = pipeline.Loader(port.train_parser, IMG, 2, 4, shuffle=True,
                             seed=1, letterbox=letterbox,
                             cache_dir=str(want_dir / f"COCO_train_{IMG}px"
                                           f"{suffix}"))
    loader.cache.willneed(np.arange(len(port.train_parser)))
    _assert_same_batches(_batches(loader), _batches(pipeline.Loader(
        port.train_parser, IMG, 2, 4, shuffle=True, seed=1,
        letterbox=letterbox, cache_dir=str(got_dir / f"COCO_train_{IMG}px"
                                           f"{suffix}"))))
    with open(want_dir / f"COCO_train_{IMG}px{suffix}" / "meta.json") as f:
        assert json.load(f)["n"] == len(port.train_parser)


def test_cached_batches_fill_the_buffers_taken(tmp_path):
    """``Loader.batches(take)`` gathers into the arrays ``take`` gives."""
    parser = synthetic.SyntheticParser(6, img_hw=64, seed=1)
    d = cache.build_packed_cache(parser, 32, str(tmp_path / "c"))
    loader = pipeline.Loader(parser, 32, 2, 4, cache_dir=d)
    given = []

    def take(shape, dtype):
        given.append(np.full(shape, 7, dtype))
        return given[-1]

    got = list(loader.batches(take))
    assert len(got) == len(given) == 3
    for b, buf in zip(got, given):
        assert b.images is buf
    _assert_same_batches(got, _batches(loader))


def test_trainer_uint8_batch_equals_float32(tmp_path):
    """The Trainer's uint8 path (``_device_batch`` divides by 255 on the
    device, as JAX's) against the float32 batch ``u8 / 255`` made on the
    host: the device batch with and without augmentation, bit for bit, and
    the eval step's losses on it."""
    cfg = Config(model_name="YOLOv5", img_size=64, batch_size=2,
                 synthetic_size=4, max_boxes=4, log_dir=str(tmp_path))
    trainer = loop.Trainer(cfg, device="cpu")
    b = next(iter(pipeline.Loader(synthetic.SyntheticParser(2, img_hw=64),
                                  64, 2, 4)))
    u8 = np.random.RandomState(0).randint(0, 256, b.images.shape).astype(
        np.uint8)
    f32 = u8.astype(np.float32) / np.float32(255)
    for augment in (False, True):
        outs = []
        for images in (u8, f32):
            trainer.aug_gen.manual_seed(11)
            outs.append(trainer._device_batch(b._replace(images=images),
                                              augment))
        for g, w in zip(*outs):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)
        assert outs[0][0].dtype == torch.float32
    losses = [trainer.eval_step(trainer.state, *trainer._device_batch(
        Batch(images, b.labels, b.boxes, b.mask), False))
        for images in (u8, f32)]
    assert losses[0].keys() == losses[1].keys()
    for k in losses[0]:
        assert torch.equal(losses[0][k], losses[1][k]), k
    trainer.ckpt.close()
    trainer.writer.close()


def test_pinned_ring_waits_for_a_slots_copy(monkeypatch):
    """``PinnedRing``'s bookkeeping, with the pinning and the CUDA events
    replaced by fakes (no card here; ``chip_smoke.py check_ring`` holds the
    copies on the card): one slot a batch, round robin; ``take`` waits on
    the event that ``upload`` recorded for that slot before handing it out
    again; the batch's other arrays go into the same slot; a batch whose
    images were not taken from the ring is refused; a slot grows to fit."""
    waited = []

    class Event:
        def record(self):
            pass

        def synchronize(self):
            waited.append(self)

    empty = torch.empty
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))
    ring = loop.PinnedRing(2, torch.device("cpu"))
    rng = np.random.RandomState(0)
    shape = (2, 4, 4, 3)
    small = (rng.randint(0, 5, (2, 3)).astype(np.int32),
             rng.rand(2, 3, 4).astype(np.float32), rng.rand(2, 3) > 0.5)
    sent = []
    for k in range(3):
        images = ring.take(shape, np.uint8)
        images[...] = rng.randint(0, 256, shape)
        batch = Batch(images, *small)
        out = ring.upload(batch)
        for t, a in zip(out, batch):
            np.testing.assert_array_equal(t.numpy(), a)
        sent.append(ring.events[k % 2])
        assert len(waited) == max(k - 1, 0)     # slot 0 again at k = 2
    assert waited == [sent[0]] and ring.next == 1
    assert ring.buffers[0]["images"].data_ptr() == images.ctypes.data
    assert set(ring.buffers[0]) == {"images", "labels", "boxes", "mask"}
    with pytest.raises(ValueError, match="written into PinnedRing.take"):
        ring.upload(Batch(np.zeros(shape, np.uint8), *small))
    bigger = ring.take((3, 4, 4, 3), np.float32)
    assert bigger.shape == (3, 4, 4, 3) and bigger.dtype == np.float32
    assert ring.buffers[1]["images"].numel() == bigger.nbytes
