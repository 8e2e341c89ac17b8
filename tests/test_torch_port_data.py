"""The port's data layer (``objectdetectionpl_tpu_torch.data``) against the JAX package.

Synthetic examples, the padding helpers, the Loader's batches and the
train/val split must equal JAX's bit for bit: the port's Loader resizes
through its own copy of the JAX library's resize (``csrc/preproc.cc``,
built under ``build/native/``), so images, boxes, labels and masks are
compared with ``assert_array_equal``.  The port's torch resize, taken where the library
cannot be built, is held against the library within 1e-6 (the same
resize, ``F.interpolate``'s float32 arithmetic against the library's),
at 64 px and upscaled to 640.
Images are 64-96 px, batches of 2-3.

The tests that compare with JAX's Loader need the JAX package's own
library, ``native/libpreproc.so``, which its binding builds with ``make``
on first use and, if that first load fails, never tries again in the
process.  Under ``pytest -n`` several workers run that ``make`` at once,
each writing the file in place, so a worker can load a file that another
worker's linker is still writing, and JAX's Loader then resizes with
cv2/PIL (up to 1/255 off).  The ``jax_library`` fixture waits, under a
file lock, until the library loads, clears the binding's cached failure,
and fails the test, naming the loader's error, when it does not load
within ``JAX_LIBRARY_DEADLINE_S``.
"""

import ctypes
import fcntl
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.data import datamodules as jax_dm
from objectdetectionpl_tpu.data import native as jax_native
from objectdetectionpl_tpu.data import pipeline as jax_pipe
from objectdetectionpl_tpu.data import synthetic as jax_syn
from objectdetectionpl_tpu.data import types as jax_types
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import datamodules, native, pipeline
from objectdetectionpl_tpu_torch.data import synthetic, types
from objectdetectionpl_tpu_torch.parallel import data_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIBRARY_DEADLINE_S = 120.0


def _load_jax_library():
    """One attempt: load ``native/libpreproc.so`` as it is (building it
    when it is missing), then reset the JAX binding's cache and load it
    there.  Returns None on success, else the reason."""
    path = jax_native._LIB_PATH
    if not os.path.exists(path):
        out = subprocess.run(["make", "-C", os.path.dirname(path)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            return f"make -C native failed: {out.stderr.strip()[-2000:]}"
    try:
        ctypes.CDLL(path)
    except OSError as e:            # missing or still being written
        return f"ctypes.CDLL({path!r}): {e}"
    jax_native._lib, jax_native._load_failed = None, False
    if not jax_native.available():
        return "jax_native.available() is False"
    return None


@pytest.fixture(scope="module")
def jax_library():
    """The JAX package's native library, loaded in this process."""
    lock = Path(REPO, "build", "jax_native.lock")
    lock.parent.mkdir(exist_ok=True)
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        deadline = time.monotonic() + JAX_LIBRARY_DEADLINE_S
        while (reason := _load_jax_library()) is not None:
            if time.monotonic() > deadline:
                pytest.fail(f"the JAX package's native library did not "
                            f"load in {JAX_LIBRARY_DEADLINE_S:.0f} s: "
                            f"{reason}")
            time.sleep(0.5)


class Cropped:
    """A parser whose images are cut to H x 3W/4, so letterbox pads."""

    def __init__(self, parser):
        self.parser = parser

    def __len__(self):
        return len(self.parser)

    def __getitem__(self, i):
        ex = self.parser[i]
        w = ex.image.shape[1] * 3 // 4
        return ex._replace(image=np.ascontiguousarray(ex.image[:, :w]))


def _batches(loader, epochs=1):
    return [b for _ in range(epochs) for b in loader]


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for name in ("images", "labels", "boxes", "mask"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_native_library_builds_under_build(jax_library):
    assert jax_native.available() and native.available()
    lib = native.library_path()
    assert lib.parent == Path(REPO, "build", "native") and lib.exists()
    assert lib.name.startswith("libpreproc-") and native.build_error is None
    # the port's own sources, nothing of native/: no libjpeg to link
    assert all(f.parent == Path(REPO, "objectdetectionpl_tpu_torch", "csrc")
               for f in native.SOURCES + native.HEADERS)
    src = b"".join(f.read_bytes() for f in native.SOURCES)
    assert b"preproc_batch" in src and b"jpeglib" not in src


@pytest.mark.parametrize("seed,img_hw", [(1, 256), (3, 96), (0, 64)])
def test_synthetic_examples_equal_jax(seed, img_hw):
    port = synthetic.SyntheticParser(6, img_hw=img_hw, seed=seed)
    ref = jax_syn.SyntheticParser(6, img_hw=img_hw, seed=seed)
    assert len(port) == len(ref) and port.classes == ref.classes
    for i in range(len(port)):
        a, b = port[i], ref[i]
        for name in ("image", "boxes", "labels"):
            assert getattr(a, name).dtype == getattr(b, name).dtype
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_padding_helpers_equal_jax():
    rng = np.random.RandomState(0)
    boxes = [rng.uniform(0, 50, (n, 4)).astype(np.float32) for n in (0, 3, 7)]
    labels = [rng.randint(0, 3, len(b)).astype(np.int32) for b in boxes]
    for got, want in zip(types.pad_targets(boxes, labels, 5),
                         jax_types.pad_targets(boxes, labels, 5)):
        np.testing.assert_array_equal(got, want)
    for b in boxes:
        np.testing.assert_array_equal(
            types.topleft_to_center_norm(b, 64, 48),
            jax_types.topleft_to_center_norm(b, 64, 48))


LOADER_CASES = {
    # shuffled over two epochs; 11 images in batches of 3: drop_last
    "shuffle_2_epochs": dict(size=11, kw=dict(batch_size=3, shuffle=True,
                                              seed=5), epochs=2),
    "keep_last": dict(size=7, kw=dict(batch_size=3, drop_last=False),
                      epochs=1),
    "limit_batches": dict(size=12, kw=dict(batch_size=2, shuffle=True,
                                           limit_batches=2), epochs=2),
    "indices": dict(size=10, kw=dict(batch_size=2, indices=[7, 1, 4, 9, 0]),
                    epochs=1),
    "shard_1_of_3": dict(size=13, kw=dict(batch_size=2, shuffle=True, seed=2,
                                          num_shards=3, shard_id=1),
                         epochs=2),
    "shard_2_of_3": dict(size=13, kw=dict(batch_size=2, shuffle=True, seed=2,
                                          num_shards=3, shard_id=2),
                         epochs=1),
    "letterbox": dict(size=5, kw=dict(batch_size=2, letterbox=True),
                      epochs=1, crop=True),
    "letterbox_shuffled": dict(size=7, kw=dict(batch_size=3, shuffle=True,
                                               letterbox=True, max_boxes=2),
                               epochs=2, crop=True),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_equal_jax(case, jax_library):
    c = LOADER_CASES[case]
    port_parser = synthetic.SyntheticParser(c["size"], img_hw=96, seed=4)
    ref_parser = jax_syn.SyntheticParser(c["size"], img_hw=96, seed=4)
    if c.get("crop"):
        port_parser, ref_parser = Cropped(port_parser), Cropped(ref_parser)
    kw = dict(dict(img_size=64, max_boxes=4), **c["kw"])
    port = pipeline.Loader(port_parser, **kw)
    ref = jax_pipe.Loader(ref_parser, **kw)
    assert port.resize_path == "native"
    assert len(port) == len(ref)
    _assert_same_batches(_batches(port, c["epochs"]),
                         _batches(ref, c["epochs"]))


@pytest.mark.parametrize("letterbox", [False, True])
def test_torch_resize_path_matches_the_library(letterbox):
    parser = Cropped(synthetic.SyntheticParser(4, img_hw=96, seed=6))
    native_loader = pipeline.Loader(parser, 64, 2, 4, letterbox=letterbox)
    torch_loader = pipeline.Loader(parser, 64, 2, 4, letterbox=letterbox)
    torch_loader.resize_path = "torch"
    for a, b in zip(torch_loader, native_loader):
        np.testing.assert_allclose(a.images, b.images, rtol=0, atol=1e-6)
        for name in ("labels", "boxes", "mask"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    # upscaled to 640, as the flagship configuration resizes
    images = [parser[i].image for i in range(2)]
    got = pipeline._torch_preproc(images, 640, letterbox)
    want = native.preproc_batch(images, 640, letterbox)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_torch_resize_is_exact_on_a_copy():
    img = np.random.RandomState(0).randint(0, 256, (9, 7, 3)).astype(np.uint8)
    out = pipeline.torch_resize(img, 7, 9)
    np.testing.assert_array_equal(out.numpy(),
                                  img.astype(np.float32) * pipeline.INV_255)


def test_resize_path_without_the_library(tmp_path):
    """No compiler: the build fails, the Loader takes the torch path."""
    code = ("import os, pathlib, sys\n"
            "os.environ['CXX'] = '/nonexistent/g++'\n"
            "from objectdetectionpl_tpu_torch.data import native, pipeline\n"
            "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "from objectdetectionpl_tpu_torch.data.synthetic import "
            "SyntheticParser\n"
            "l = pipeline.Loader(SyntheticParser(4, img_hw=64), 32, 2)\n"
            "b = next(iter(l))\n"
            "print(l.resize_path, b.images.shape, native.available())\n"
            "print(native.build_error)\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, error = out.stdout.splitlines()
    assert first.split() == ["torch", "(2,", "32,", "32,", "3)", "False"]
    assert "FileNotFoundError" in error and "/nonexistent/g++" in error


def test_random_split_equals_jax():
    for n, frac, seed in ((10, 0.8, 42), (57, 0.8, 0), (5, 0.5, 3)):
        for got, want in zip(pipeline.random_split_indices(n, frac, seed),
                             jax_pipe.random_split_indices(n, frac, seed)):
            np.testing.assert_array_equal(got, want)


def test_prefetch_keeps_order_and_raises_after_the_items():
    assert list(pipeline.prefetch(iter(range(20)), 2)) == list(range(20))

    def failing():
        yield 1
        yield 2
        raise KeyError("worker")

    got = []
    with pytest.raises(KeyError, match="worker"):
        for item in pipeline.prefetch(failing(), 1):
            got.append(item)
    assert got == [1, 2]


def test_prefetch_stops_its_thread_when_closed():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    before = threading.active_count()
    gen = pipeline.prefetch(endless(), 2)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    assert threading.active_count() == before
    n = len(produced)
    assert n <= 3 + 2 + 2              # taken, queued, one in hand


def test_data_shard_is_one_process(monkeypatch):
    """(1, 0) without a process group, whatever the environment says;
    (world size, rank) under one."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert data_shard() == (1, 0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert data_shard() == (1, 0)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    assert data_shard() == (2, 1)


def test_synthetic_module_matches_jax(jax_library):
    kw = dict(data_module="Synthetic", synthetic_size=10, batch_size=2,
              img_size=64, limit_train_batches=3, seed=3, max_boxes=4)
    port = datamodules.build_datamodule(Config(**kw))
    ref = jax_dm.build_datamodule(JaxConfig(**kw))
    assert port.get_class() == ref.get_class()
    for split in ("train", "val", "test"):
        p, r = getattr(port, f"{split}_parser"), getattr(ref, f"{split}_parser")
        assert (len(p), p.seed, p.img_hw) == (len(r), r.seed, r.img_hw)
        pl, rl = (getattr(m, f"{split}_dataloader")() for m in (port, ref))
        assert (pl.shuffle, pl.limit_batches, len(pl)) == (
            rl.shuffle, rl.limit_batches, len(rl))
        _assert_same_batches(_batches(pl), _batches(rl))


@pytest.mark.parametrize("name", ["VOC", "COCO", "BDD100K", "WiderPerson",
                                  "MosquitoContainer", "AsiaTraffic"])
def test_real_datamodules_raise(name, tmp_path):
    """All six are ported.  Without their tree VOC, COCO, WiderPerson and
    AsiaTraffic raise naming the missing file; BDD100K and
    MosquitoContainer glob for their files and, as JAX's, hold none."""
    cfg = Config(data_module=name, data_root=str(tmp_path / "none"))
    if name in ("BDD100K", "MosquitoContainer"):
        port = datamodules.build_datamodule(cfg)
        ref = jax_dm.build_datamodule(JaxConfig(data_module=name,
                                                data_root=cfg.data_root))
        assert len(port.train_parser) == len(ref.train_parser) == 0
        assert port.get_class() == ref.get_class()
        return
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "none")):
        datamodules.build_datamodule(cfg)


def test_cache_dir_raises(tmp_path):
    """A cache_dir without a cache of the Loader's geometry is refused:
    here a cache built at 64 px, asked for at 32 px or with letterbox
    (the JAX Loader decodes live instead; ROADMAP §C)."""
    from objectdetectionpl_tpu_torch.data import cache
    parser = synthetic.SyntheticParser(4, img_hw=64)
    d = str(tmp_path / "c")
    cache.build_packed_cache(parser, 64, d)
    assert pipeline.Loader(parser, 64, 2, cache_dir=d).decode_path == "cache"
    for kw in (dict(img_size=32), dict(img_size=64, letterbox=True)):
        with pytest.raises(ValueError, match="no packed cache of 4 images"):
            pipeline.Loader(parser, batch_size=2, cache_dir=d, **kw)
    with pytest.raises(ValueError, match="no packed cache"):
        pipeline.Loader(parser, 64, 2, cache_dir=str(tmp_path / "none"))
    with pytest.raises(ValueError, match="unknown data_module"):
        datamodules.build_datamodule(Config(data_module="Nope"))
