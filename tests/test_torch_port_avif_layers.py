"""Layered AVIF and AV1 inter frames through the port's reader
(``data/formats.py::read_avif`` over ``csrc/av1_decode.cc``) against
JAX's ``load_image_rgb`` -- cv2 5.0 over libavif 1.4.2 and its libaom --
bit for bit.

libavif hands libaom the item's data (or, under an lsel, a1lx's layers
up to the selected one) and asks for a1op's operating point; libaom
decodes every frame of the points' layers and hands back the last one
shown (under an lsel libavif takes the selected layer's).  The
enhancement layers of the system libaom's (3.6) spatial layers are inter
frames, so the cases here run the AV1 inter decoding process:

- the committed layered fixtures (``format_files.avif_layer_files``):
  three key-frame layers (the port once returned layer 0 where cv2
  returns layer 2), realtime SVC, quality layers, scaled base layers,
  10 bits, two operating points;
- each inter tool on over a base with the others off, in layered items
  or in an item holding a sequence of frames (``aom_encode``'s
  ``sequence``: hidden alt-ref frames, compound prediction, frames shown
  again), each case's ``native._av1`` counts showing the tool ran;
- other subsamplings and depths of layered items;
- a1op, lsel and a1lx as libavif reads them, and what it refuses of them;
- bit flips in the inter frames (both refuse, or both read the same);
- what the port refuses by name while cv2 reads it, and streams with
  frames lost.

Every stream is written here by the system libaom through ctypes; the
cases skip where it is absent.  The file runs in about 20 s on one
worker.
"""

import struct

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import formats, native
from objectdetectionpl_tpu_torch.tools import av1_tables, format_files
from objectdetectionpl_tpu_torch.tools.format_files import (
    aom_encode, av1_obus, av1c_bytes, avif_bytes, heif_box)

needs_libaom = pytest.mark.skipif(av1_tables.find_libaom() is None,
                                  reason="no libaom.so.3 to write streams")

LAYER_FIXTURES = ("avif_layers_key", "avif_layers_realtime",
                  "avif_layers_quality", "avif_layers_scaled",
                  "avif_layers_10bit", "avif_layers_ops")


def _file(tmp_path, data: bytes, name="x.avif") -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _same_as_cv2(path: str) -> np.ndarray:
    want = load_image_rgb(path)
    got = native.decode_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _both_refuse(path: str) -> None:
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None
    with pytest.raises(native.ImageError, match=f"^{path}"):
        native.decode_image(path)


def _item(data: bytes) -> bytes:
    """The primary item's data of a file ``avif_bytes`` wrote."""
    boxes = list(formats._jp2_boxes(data, 0, len(data)))
    meta = [formats._avif_meta(data, a, s) for k, a, s in boxes
            if k == b"meta"][0]
    return formats._avif_item_data(data, meta, meta["pitm"])


def _box(stream: bytes, h: int, w: int, depth: int = 8, sub="4:2:0",
         props=()) -> bytes:
    return avif_bytes(stream, w, h, av1c_bytes(sub, depth),
                      pixi=(depth,) * (1 if sub == "4:0:0" else 3),
                      extra_props=props)


def _rgb():
    return native.decode_one(str(format_files.TESTDATA / format_files.BASE))


def _frames(seed: int, n: int = 6, h: int = 96, w: int = 128) -> list:
    """n 4:2:0 frames of a crop of the 500x375 fixture turning, zooming
    and moving a little from one to the next (seeded)."""
    rng = np.random.default_rng(seed)
    y0, x0 = int(rng.integers(40, 220)), int(rng.integers(40, 300))
    dy, dx = int(rng.integers(-3, 4)), int(rng.integers(-3, 4))
    zoom, turn = 1 + 0.02 * int(rng.integers(-3, 4)), float(rng.integers(-3, 4))
    rgb = np.ascontiguousarray(_rgb())
    out = []
    for k in range(n):
        m = cv2.getRotationMatrix2D((x0 + w / 2, y0 + h / 2), turn * k,
                                    zoom ** k)
        m[0, 2] += k * dx
        m[1, 2] += k * dy
        img = cv2.warpAffine(rgb, m, (500, 375),
                             borderMode=cv2.BORDER_REFLECT)
        out.append(format_files._yuv(img[y0:y0 + h, x0:x0 + w], "4:2:0"))
    return out


def _sequence(seed: int, cpu: int, cq: int, lag: int = 5, **options):
    fr = _frames(seed)
    return aom_encode(fr[0], sequence=fr[1:], lag=lag,
                      options={"cpu-used": cpu, "cq-level": cq, **options})


# ---------------------------------------------------------------------------
# the committed fixtures

@pytest.mark.parametrize("kind", LAYER_FIXTURES)
def test_layer_fixtures_as_cv2(kind):
    """Each committed layered file reads as cv2 reads it: the layers
    decoded, the top one (or the operating point's) returned."""
    path = str(format_files.COMMITTED[kind])
    got = _same_as_cv2(path)
    data = format_files.COMMITTED[kind].read_bytes()
    op = 1 if kind == "avif_layers_ops" else 0
    _, info = native._av1(_item(data), op)
    frames, inter = {"avif_layers_key": (3, 0), "avif_layers_ops": (1, 0),
                     "avif_layers_quality": (3, 1),
                     "avif_layers_10bit": (3, 1)}.get(kind, (3, 2))
    assert (info["frames"], info["inter_frames"]) == (frames, inter)
    if kind == "avif_layers_scaled":
        assert info["scaled_blocks"] == info["inter_blocks"] > 0
    if kind in ("avif_layers_quality", "avif_layers_10bit"):
        assert info["warp_blocks"] > 0
    if kind == "avif_layers_key":
        # the base layer alone is another image: the port once read it
        base = b"".join(raw for k, raw, _ in av1_obus(_item(data))[:3])
        planes, _ = native._av1(base)
        ours = native._av1(_item(data))[0]
        assert not np.array_equal(planes[0], ours[0])
        assert got.shape == (120, 160, 3)


@needs_libaom
def test_committed_layer_fixtures():
    """``format_files.avif_layer_files`` is the recipe of the committed
    layered AVIFs (``chip_smoke.py formats`` serves them): the same
    bytes again."""
    files = format_files.avif_layer_files()
    assert sorted(files) == sorted(LAYER_FIXTURES)
    for kind, data in files.items():
        assert format_files.COMMITTED[kind].read_bytes() == data, kind


# ---------------------------------------------------------------------------
# the inter tools, one at a time

# libaom's inter tools, all off; onesided compound stays on (without it
# the encoder uses no compound prediction in these short sequences)
OFF = {k: 0 for k in (
    "enable-obmc", "enable-warped-motion", "enable-interintra-comp",
    "enable-masked-comp", "enable-dist-wtd-comp", "enable-dual-filter",
    "enable-ref-frame-mvs", "enable-global-motion", "enable-diff-wtd-comp",
    "enable-interinter-wedge", "enable-interintra-wedge",
    "enable-smooth-interintra")}

# tool: (its options over OFF, the sequence's seed, cpu-used, cq-level,
# the count it must show)
TOOL_CASES = {
    "compound_average": ({}, 5, 2, 20, "compound_blocks"),
    "obmc": ({"enable-obmc": 1}, 0, 0, 20, "obmc_blocks"),
    "local_warp": ({"enable-warped-motion": 1}, 0, 0, 20, "warp_blocks"),
    "diffwtd_compound": ({"enable-masked-comp": 1,
                          "enable-diff-wtd-comp": 1}, 5, 2, 20,
                         "diffwtd_compound_blocks"),
    "wedge_compound": ({"enable-masked-comp": 1,
                        "enable-interinter-wedge": 1}, 6, 0, 25,
                       "wedge_compound_blocks"),
    "distance_compound": ({"enable-dist-wtd-comp": 1}, 4, 1, 40,
                          "distance_blocks"),
    "temporal_mvs": ({"enable-ref-frame-mvs": 1}, 0, 0, 20, "temporal_mvs"),
    "dual_filter": ({"enable-dual-filter": 1}, 0, 0, 20,
                    "dual_filter_blocks"),
    "smooth_interintra": ({"enable-interintra-comp": 1,
                           "enable-smooth-interintra": 1}, 1, 1, 25,
                          "interintra_blocks"),
}


@needs_libaom
@pytest.mark.parametrize("tool", sorted(TOOL_CASES))
def test_inter_tool_as_cv2(tmp_path, tool):
    """Each inter tool in an item holding a short sequence (key frame,
    inter frames, hidden alt-refs): the port's counts show the tool ran,
    and the file reads as cv2 reads it."""
    options, seed, cpu, cq, count = TOOL_CASES[tool]
    stream = _sequence(seed, cpu, cq, **{**OFF, **options})
    _, info = native._av1(stream)
    assert info[count] > 0, (tool, info)
    _same_as_cv2(_file(tmp_path, _box(stream, 96, 128)))


@needs_libaom
def test_wedge_interintra_layers_as_cv2(tmp_path):
    """Wedge inter-intra in the top layer of good-quality layers over a
    scaled base layer (with OBMC, local warp, dual filters)."""
    planes = format_files._yuv(_rgb()[101:230, 73:111], "4:2:0")
    stream = aom_encode(None, layers=[
        {"planes": planes, "cq_level": 18, "scale": (6, 6)},
        {"planes": planes, "cq_level": 8}, {"planes": planes}],
        options={"cpu-used": 0})
    _, info = native._av1(stream)
    assert info["wedge_interintra_blocks"] > 0 and info["obmc_blocks"] > 0
    _same_as_cv2(_file(tmp_path, _box(stream, 129, 38)))


@needs_libaom
def test_frame_shown_again_as_cv2(tmp_path):
    """A sequence whose hidden alt-ref is shown again by
    show_existing_frame: that frame is the one libaom hands back."""
    rgb = _rgb()
    fr = [format_files._yuv(rgb[210 - 3 * k:306 - 3 * k,
                                28 + 3 * k:164 + 3 * k], "4:2:0")
          for k in range(5)]
    stream = aom_encode(fr[0], sequence=fr[1:], lag=9,
                        options={"cpu-used": 1, "cq-level": 22})
    _, info = native._av1(stream)
    assert info["shown_existing"] > 0 and info["frames"] > 5
    _same_as_cv2(_file(tmp_path, _box(stream, 96, 136)))


@needs_libaom
@pytest.mark.parametrize("sub,depth", [("4:4:4", 8), ("4:2:2", 8),
                                       ("4:0:0", 8), ("4:2:0", 12)])
def test_layers_subsampling_and_depth(tmp_path, sub, depth):
    """Good-quality layers at cq-levels 50, 30, 10 in other subsamplings
    and at 12 bits."""
    rgb = _rgb()[100:220, 150:310]
    planes = format_files._yuv(rgb, "4:2:0" if sub == "4:0:0" else sub)
    planes = planes[:1] if sub == "4:0:0" else planes
    if depth > 8:
        planes = format_files.deepen(planes, depth)
    stream = aom_encode(None, sub, bit_depth=depth, options={"cpu-used": 4},
                        layers=[{"planes": planes, "cq_level": q}
                                for q in (50, 30, 10)])
    _, info = native._av1(stream)
    assert info["frames"] == 3 and info["inter_frames"] >= 1
    _same_as_cv2(_file(tmp_path, _box(stream, 120, 160, depth, sub)))


# ---------------------------------------------------------------------------
# a1op, lsel, a1lx

def _a1op(i):
    return heif_box(b"a1op", bytes([i]))


def _lsel(layer):
    return heif_box(b"lsel", struct.pack(">H", layer))


def _a1lx(sizes, large=False):
    return heif_box(b"a1lx", bytes([int(large)]) + b"".join(
        struct.pack(">I" if large else ">H", v) for v in sizes))


def _realtime():
    """The realtime fixture's stream, its OBU sizes, and the stream with
    two operating points (all layers; the base layer alone)."""
    stream = _item(format_files.COMMITTED["avif_layers_realtime"]
                   .read_bytes())
    two = format_files.with_operating_points(stream,
                                             [(0x701, 13), (0x101, 13)])
    return stream, [len(raw) for _, raw, _ in av1_obus(stream)], two


# case: (the stream: 3 layers or two points, the properties (box,
# essential), whether cv2 reads it)
def _property_cases():
    stream, sizes, two = _realtime()
    head = sum(sizes[:3])       # delimiter, sequence header, base layer
    return {
        "a1op_0": (two, ((_a1op(0), True),), True),
        "a1op_1_base_layer": (two, ((_a1op(1), True),), True),
        "a1op_past_the_points": (two, ((_a1op(31), True),), True),
        "a1op_32": (two, ((_a1op(32), True),), False),
        "a1op_not_essential": (two, ((_a1op(1), False),), False),
        "a1op_empty": (two, ((heif_box(b"a1op", b""), True),), False),
        "two_a1op": (two, ((_a1op(1), True), (_a1op(0), True)), True),
        "lsel_0": (stream, ((_lsel(0), True),), True),
        "lsel_1": (stream, ((_lsel(1), True),), True),
        "lsel_2": (stream, ((_lsel(2), True),), True),
        "lsel_3_absent": (stream, ((_lsel(3), True),), False),
        "lsel_4": (stream, ((_lsel(4), True),), False),
        "lsel_ffff": (stream, ((_lsel(0xFFFF), True),), True),
        "lsel_not_essential": (stream, ((_lsel(1), False),), False),
        "a1op_1_lsel_0": (two, ((_a1op(1), True), (_lsel(0), True)), True),
        "a1op_1_lsel_2": (two, ((_a1op(1), True), (_lsel(2), True)), False),
        "a1lx": (stream, ((_a1lx([head, sizes[3], 0]), False),), True),
        "a1lx_32_bit": (stream, ((_a1lx([head, sizes[3], 0], True),
                                  False),), True),
        "a1lx_reserved_bits": (stream, ((heif_box(b"a1lx", b"\x02" + bytes(
            6)), False),), False),
        "a1lx_truncated": (stream, ((heif_box(b"a1lx", b"\x00" + bytes(4)),
                                     False),), False),
        "a1lx_layer_past_the_item": (stream, ((_a1lx(
            [head, sum(sizes[3:]), 0]), False),), False),
        "a1lx_lsel_1": (stream, ((_a1lx([head, sizes[3], 0]), False),
                                 (_lsel(1), True)), True),
        "a1lx_lsel_0_cut": (stream, ((_a1lx([head - 40, 0, 0]), False),
                                     (_lsel(0), True)), False),
        "a1lx_lsel_past_its_layers": (stream, ((_a1lx([head, 0, 0]), False),
                                               (_lsel(2), True)), False),
    }


@pytest.mark.parametrize("case", sorted(_property_cases()))
def test_layer_properties_as_cv2(tmp_path, case):
    """a1op asks libaom for an operating point (0..31, 0 where the stream
    has fewer), lsel for a layer's first frame of all the layers (0..3
    or 0xFFFF for none), a1lx cuts the item under an lsel; both of the
    first must be essential, an a1lx's sizes fit the item."""
    stream, props, reads = _property_cases()[case]
    path = _file(tmp_path, _box(stream, 120, 160, props=props))
    if reads:
        _same_as_cv2(path)
    else:
        _both_refuse(path)


def test_layer_selection_takes_each_layer(tmp_path):
    """lsel 0, 1 and 2 of the quality layers (cq-levels 50, 30, 10) give
    three different images, the top one the file's own; a1op 1 of the
    realtime layers' two operating points gives their base layer (lsel
    0's)."""
    stream = _item(format_files.COMMITTED["avif_layers_quality"]
                   .read_bytes())
    imgs = [_same_as_cv2(_file(tmp_path, _box(stream, 120, 160, props=(
        (_lsel(layer), True),)), f"l{layer}.avif")) for layer in range(3)]
    assert not np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[1], imgs[2])
    np.testing.assert_array_equal(imgs[2], _same_as_cv2(
        str(format_files.COMMITTED["avif_layers_quality"])))
    realtime, _, two = _realtime()
    base = _same_as_cv2(_file(tmp_path, _box(two, 120, 160, props=(
        (_a1op(1), True),)), "op1.avif"))
    np.testing.assert_array_equal(base, _same_as_cv2(_file(
        tmp_path, _box(realtime, 120, 160, props=((_lsel(0), True),)),
        "rt0.avif")))


# ---------------------------------------------------------------------------
# damaged and refused streams

@pytest.mark.parametrize("seed", range(8))
def test_damaged_inter_frames(tmp_path, seed):
    """A bit flipped in an inter frame of the realtime fixture: libaom
    refuses it (a tile's symbols do not end where its data does) or
    reads what the port reads."""
    data = bytearray(format_files.COMMITTED["avif_layers_realtime"]
                     .read_bytes())
    start = bytes(data).index(b"mdat") + 4
    spans, at = [], start
    for _, raw, _ in av1_obus(bytes(data[start:])):
        spans.append((at, at + len(raw)))
        at += len(raw)
    rng = np.random.default_rng(seed)
    lo, hi = spans[3 + seed % 2]
    data[int(rng.integers(lo + 3, hi))] ^= 1 << int(rng.integers(8))
    path = _file(tmp_path, bytes(data))
    if cv2.imread(path, cv2.IMREAD_COLOR) is None:
        _both_refuse(path)
    else:
        _same_as_cv2(path)


@needs_libaom
def test_scaled_compound_refused_by_name(tmp_path):
    """Frames coded at 8/14 of the key frame's size (libaom's fixed
    resize) with compound prediction from the scaled key frame (the
    item's ispe the last frame's size): cv2 reads it, the port refuses,
    naming the tool."""
    fr = _frames(0)
    stream = aom_encode(fr[0], sequence=fr[1:], lag=5, resize=(1, 14),
                        options={"cpu-used": 0, "cq-level": 30})
    shown = native.av1_probe(stream)      # the last frame, 8/14 of 128x96
    assert (shown["width"], shown["height"]) == (73, 55)
    path = _file(tmp_path, _box(stream, 55, 73))
    assert load_image_rgb(path) is not None
    with pytest.raises(native.ImageError, match=f"^{path}: AVIF: the AV1 "
                       "stream uses compound prediction from a scaled "
                       "reference"):
        native.decode_image(path)


@needs_libaom
@pytest.mark.parametrize("drop", [1, 2, 3])
def test_lost_frames(tmp_path, drop):
    """An error-resilient sequence with a temporal unit cut out: its
    frame ids (or the order hints of its slots) no longer match, and
    libaom and the port refuse it."""
    fr = _frames(3, n=5)
    stream = aom_encode(fr[0], sequence=fr[1:], options={
        "cpu-used": 4, "cq-level": 30, "error-resilient": 1})
    units, cur = [], b""
    for kind, raw, _ in av1_obus(stream):
        if kind == 2 and cur:
            units.append(cur)
            cur = b""
        cur += raw
    units.append(cur)
    _same_as_cv2(_file(tmp_path, _box(stream, 96, 128), "whole.avif"))
    cut = b"".join(u for i, u in enumerate(units) if i != drop)
    _both_refuse(_file(tmp_path, _box(cut, 96, 128)))
