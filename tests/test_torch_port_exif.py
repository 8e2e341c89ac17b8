"""EXIF orientation in the port's image reading, against the JAX package.

The JAX package reads images with ``cv2.imread``, which turns them by the
EXIF Orientation tag, in ``load_image_rgb`` (its parsers' examples and its
predict CLI) and so in its packed cache; its fused libjpeg loader does not
turn them.  The port's decoder reads the tag (``csrc/jpeg_decode.cc``) and
turns the image in exactly those places.

Fixtures are made here: an APP1 "Exif" segment with a little TIFF IFD0 is
spliced after the SOI of a committed fixture JPEG
(``objectdetectionpl_tpu_torch/data/testdata``).

- ``load_image_rgb`` equals JAX's bit for bit for Orientation 1-8 in both
  TIFF byte orders, and the image is the one cv2 turns it to.
- Malformed and unusual segments decode as cv2 decodes them, each case
  also pinned to the turn cv2 gives it: an IFD cut short, offsets outside
  the segment, an unknown value, a wrong TIFF mark, a non-Exif APP1,
  several Exif segments, a segment after the first scan; none raises.
- The packed cache of a VOC tree of such files equals JAX's
  ``build_packed_cache`` (images, boxes normalised by the turned sizes,
  labels), letterbox off and on; a cache without the port's ``exif`` mark
  (JAX's, or a stale one) is rebuilt, and a Loader reads JAX's.
- The fused float32 Loader batches stay unturned and equal JAX's fused
  libjpeg batches.
"""

import json
import struct
from pathlib import Path

import numpy as np
import pytest

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.data import cache as jax_cache
from objectdetectionpl_tpu.data import datamodules as jax_dm
from objectdetectionpl_tpu.data.parsers import VOCParser as JaxVOC
from objectdetectionpl_tpu.data.parsers.common import \
    load_image_rgb as jax_load_image_rgb
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import cache, datamodules, native
from objectdetectionpl_tpu_torch.data.parsers import VOCParser
from objectdetectionpl_tpu_torch.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.tools import fixture_trees
from test_torch_port_cache import _assert_same_cache
from test_torch_port_data import (_assert_same_batches, _batches,  # noqa: F401
                                  jax_library)

FIXTURES = ("odd_420_q75_37x53.jpg", "h2v1_422_q85_256x192.jpg",
            "gray_q85_200x150.jpg", "progressive_420_q75_160x120.jpg",
            "restart7_420_q90_333x251.jpg")
PROGRESSIVE = "progressive_420_q75_160x120.jpg"

# cv2's turns of an image for Orientation 1-8
TURNS = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
         4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
         6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
         7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1],
         8: lambda a: a.transpose(1, 0, 2)[::-1]}
O6 = (0x0112, 3, 1, 6)                 # Orientation, SHORT, 1 value: 6


def tiff(order, entries, ifd_at=8, extra=b""):
    """TIFF data: header (``order`` "II" or "MM", mark 42, IFD0 at
    ``ifd_at``), IFD0 of ``entries`` (tag, type, count, value: an int, or
    4 raw bytes), a zero next-IFD offset, then ``extra``; data after the
    IFD starts at ifd_at + 6 + 12 * len(entries)."""
    e = "<" if order == "II" else ">"
    out = order.encode() + struct.pack(e + "HI", 42, ifd_at)
    out += bytes(ifd_at - 8) + struct.pack(e + "H", len(entries))
    for tag, typ, count, value in entries:
        if isinstance(value, bytes):
            out += struct.pack(e + "HHI", tag, typ, count) + value
        elif typ == 3:                         # SHORT, left-justified
            out += struct.pack(e + "HHIHH", tag, typ, count, value, 0)
        else:
            out += struct.pack(e + "HHII", tag, typ, count, value)
    return out + struct.pack(e + "I", 0) + extra


def app1(body, prefix=b"Exif\0\0"):
    data = prefix + body
    return b"\xff\xe1" + struct.pack(">H", len(data) + 2) + data


def spliced(name, *segments, at=2):
    raw = (fixture_trees.TESTDATA / name).read_bytes()
    return raw[:at] + b"".join(segments) + raw[at:]


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _unturned(name):
    return jax_load_image_rgb(str(fixture_trees.TESTDATA / name))


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_load_image_rgb_turns_as_jax(tmp_path, orientation, order):
    name = FIXTURES[orientation % len(FIXTURES)]
    path = _write(tmp_path, "o.jpg", spliced(name, app1(tiff(
        order, [(0x010F, 2, 4, b"cam\0"), (0x0112, 3, 1, orientation)]))))
    got, want = load_image_rgb(path), jax_load_image_rgb(path)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, TURNS[orientation](_unturned(name)))
    # the decoder without ``exif`` (the fused loader's reading) never turns
    np.testing.assert_array_equal(native.decode_one(path), _unturned(name))


def _rationals(k):
    return struct.pack("<II", 1, 2) * k


# name -> (APP1 segments, or the whole file for "after_first_scan"; the
# turn cv2 gives the image)
MALFORMED = {
    "value_0": ([app1(tiff("II", [(0x0112, 3, 1, 0)]))], 1),
    "value_9": ([app1(tiff("MM", [(0x0112, 3, 1, 9)]))], 1),
    "value_65535": ([app1(tiff("II", [(0x0112, 3, 1, 65535)]))], 1),
    # a LONG is read as its first 16 bits: 6 in II, 0 in MM
    "long_II": ([app1(tiff("II", [(0x0112, 4, 1, 6)]))], 6),
    "long_MM": ([app1(tiff("MM", [(0x0112, 4, 1, 6)]))], 1),
    "prefix_not_exif": ([app1(tiff("II", [O6]), prefix=b"Exif\0X")], 1),
    "no_tiff_data": ([app1(b"")], 1),
    "tiff_header_cut": ([app1(b"II*\0")], 1),
    "wrong_mark": ([app1(tiff("II", [O6])[:2] + b"\x2b\0"
                         + tiff("II", [O6])[4:])], 1),
    "mixed_order": ([app1(b"IM" + tiff("II", [O6])[2:])], 1),
    "ifd_outside": ([app1(tiff("II", [O6])[:4] + struct.pack("<I", 4000)
                          + tiff("II", [O6])[8:])], 1),
    "ifd_at_16": ([app1(tiff("II", [O6], ifd_at=16))], 6),
    "entry_cut_in_value": ([app1(tiff("II", [O6])[:8 + 2 + 9])], 1),
    "entry_cut_after_value": ([app1(tiff("II", [O6])[:8 + 2 + 10])], 6),
    "count_past_end": ([app1(tiff("II", [O6])[:8] + struct.pack("<H", 5)
                             + tiff("II", [O6])[10:])], 6),
    "string_outside_before": ([app1(tiff("II", [(0x010F, 2, 9, 5000),
                                                O6]))], 1),
    "string_outside_after": ([app1(tiff("II", [O6, (0x0131, 2, 9,
                                                    5000)]))], 6),
    "string_inline": ([app1(tiff("MM", [(0x0110, 2, 4, 5000), O6]))], 6),
    "rational_cut_before": ([app1(tiff("II", [(0x013F, 5, 6, 38), O6],
                                       extra=_rationals(6)[:-1]))], 1),
    "rationals_before": ([app1(tiff("II", [(0x0214, 5, 6, 38), O6],
                                    extra=_rationals(6)))], 6),
    "unknown_tag_outside": ([app1(tiff("II", [(0x8825, 4, 1, 9999),
                                              O6]))], 6),
    "first_orientation_wins": ([app1(tiff("II", [O6, (0x0112, 3, 1,
                                                      3)]))], 6),
    "xmp_first": ([app1(b"http://ns.adobe.com/xap/1.0/\0<x/>", prefix=b""),
                   app1(tiff("II", [O6]))], 6),
    "second_exif_without": ([app1(tiff("MM", [(0x0100, 3, 1, 5)])),
                             app1(tiff("II", [O6]))], 6),
    "second_exif_after_malformed": ([app1(b"II*\0\xff\xff\0\0"),
                                     app1(tiff("II", [O6]))], 6),
    "second_exif_after_orientation_1": (
        [app1(tiff("II", [(0x0112, 3, 1, 1)])), app1(tiff("II", [O6]))], 1),
    "after_first_scan": (None, 1),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_unusual_exif_reads_as_cv2(tmp_path, case):
    segments, turn = MALFORMED[case]
    name = PROGRESSIVE if segments is None else FIXTURES[0]
    if segments is None:
        raw = (fixture_trees.TESTDATA / name).read_bytes()
        second_scan = raw.index(b"\xff\xda", raw.index(b"\xff\xda") + 2)
        data = spliced(name, app1(tiff("II", [O6])), at=second_scan)
    else:
        data = spliced(name, *segments)
    path = _write(tmp_path, "x.jpg", data)
    got, want = load_image_rgb(path), jax_load_image_rgb(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, TURNS[turn](_unturned(name)))


@pytest.fixture(scope="module")
def exif_voc_root(tmp_path_factory):
    """A VOC tree whose images carry Orientation 1-8 in turn, in both byte
    orders: each fixture link is replaced by a spliced copy."""
    root = fixture_trees.write_voc_tree(
        tmp_path_factory.mktemp("voc_exif"), n_train=8, n_val=2, seed=9,
        names=list(FIXTURES[:3]))
    images = sorted((Path(root) / "VOC2012" /
                     "JPEGImages").iterdir())
    for i, path in enumerate(images):
        name = FIXTURES[i % 3]
        path.unlink()                          # a link to the fixture
        path.write_bytes(spliced(name, app1(tiff(
            "II" if i % 2 else "MM", [(0x0112, 3, 1, i % 8 + 1)]))))
    return root


@pytest.mark.parametrize("letterbox", [False, True])
def test_packed_cache_of_turned_images_equals_jax(tmp_path, exif_voc_root,
                                                  letterbox):
    port = VOCParser(exif_voc_root, "2012", "train")
    ref = JaxVOC(exif_voc_root, "2012", "train")
    shapes = {port[i].image.shape[:2] for i in range(len(port))}
    assert {(37, 53), (53, 37), (256, 192)} <= shapes     # turned and not
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    cache.build_packed_cache(port, 64, got, letterbox)
    jax_cache.build_packed_cache(ref, 64, want, letterbox=letterbox)
    _assert_same_cache(got, want)


def test_unmarked_cache_is_rebuilt(tmp_path, exif_voc_root):
    """A cache without the ``exif`` mark -- JAX's, or one the port built
    before it turned images, whose rows may be unturned -- is rebuilt by
    ``build_packed_cache``, while a Loader given JAX's reads it."""
    port = VOCParser(exif_voc_root, "2012", "train")
    ref = JaxVOC(exif_voc_root, "2012", "train")
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    jax_cache.build_packed_cache(ref, 64, want)
    assert not cache.cache_valid(want, len(port), 64, False)
    assert cache.maybe_open(want, len(port), 64, False) is not None
    # the stale cache: unmarked, its rows not what the files decode to
    cache.build_packed_cache(port, 64, got)
    with open(f"{got}/meta.json") as f:
        meta = json.load(f)
    del meta["exif"]
    with open(f"{got}/meta.json", "w") as f:
        json.dump(meta, f)
    np.memmap(f"{got}/images.u8", np.uint8, "r+")[:] = 0
    assert cache.cache_valid(got, len(port), 64, False, exif=False)
    assert not cache.cache_valid(got, len(port), 64, False)
    cache.build_packed_cache(port, 64, got)
    _assert_same_cache(got, want)


def test_fused_loader_stays_unturned(exif_voc_root, jax_library):
    kw = dict(data_module="VOC", data_root=exif_voc_root, batch_size=3,
              img_size=64, max_boxes=4, seed=5, stage="all")
    port = datamodules.build_datamodule(Config(**kw))
    ref = jax_dm.build_datamodule(JaxConfig(**kw))
    pl, rl = port.train_dataloader(), ref.train_dataloader()
    assert pl.decode_path == "fused"
    _assert_same_batches(_batches(pl), _batches(rl))
    # the fused call reads the files unturned unless asked
    paths = [port.train_parser.record(i)[0] for i in range(4)]
    plain = native.decode_preproc_batch(paths, 64, False)[0]
    unturned = native.preproc_batch(
        [native.decode_one(p) for p in paths], 64, False)[0]
    turned = native.preproc_batch([load_image_rgb(p) for p in paths], 64,
                                  False)[0]
    np.testing.assert_array_equal(plain, unturned)
    np.testing.assert_array_equal(
        native.decode_preproc_batch(paths, 64, False, exif=True)[0], turned)
    assert not np.array_equal(plain, turned)
