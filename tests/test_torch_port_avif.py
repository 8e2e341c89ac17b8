"""AVIF through the port's reader (``data/formats.py::read_avif``, the AV1
decoder ``csrc/av1_decode.cc`` and libavif's YUV -> RGB) against JAX's
``load_image_rgb`` -- cv2 5.0's AvifDecoder over libavif 1.4.2 and its
libaom -- bit for bit, on seeded images of at most 160x120 (a few of
up to 160x192) that Pillow's AVIF encoder (libavif over aom),
cv2.imwrite and the system libaom write here.

- the sniff: libavif's brand rule (major or compatible avif / avis) over
  the 500 bytes cv2's signature check parses;
- the container: iloc versions, field sizes, idat, several extents,
  15-bit and version-1 ipma, infe v3, a hidden primary item, the
  properties cv2 ignores (pixi absent, irot, imir, clap, an ICC colr,
  pasp, clli, auxC, a1op, lsel, a1lx) and an alpha item; what cv2
  refuses (an essential property libavif does not know, pixi depths off
  av1C's, idat read as the file, cut files, bits flipped in the AV1
  data);
- the OBUs libaom takes (size fields, delimiters, padding, metadata,
  reserved and tile list OBUs, zero bytes after the frame, a sequence
  header in av1C only, a header's trailing bits and the bytes after
  them, undefined levels, a reduced header for a video);
- the AV1 tools one at a time over a tools-off base (4:4:4 with the
  identity matrix, so cv2 hands back the decoded planes), the
  subsamplings, sizes from 1x1 to 65x33, tiles, 128x128 superblocks,
  delta q and adaptive quantization, quantizer matrices, lossless;
- the colour conversions: every matrix, range, subsampling and (for
  matrix 12) colour primaries cv2 reads, and the combinations cv2
  refuses;
- the stages after CDEF, each case's ``native.av1_probe`` fields showing
  what it exercises: loop restoration (Wiener, self-guided and switchable
  units, luma and chroma, 64 and 128 superblocks, 4:2:0 / 4:4:4 / 4:0:0),
  superres (denominators 9 to 16, odd widths, two tile columns, with and
  without restoration, every subsampling; written by
  ``tools/format_files.py::aom_encode``, the system libaom through
  ctypes, and skipped where it is absent) and film grain (libaom's test
  vectors at odd sizes in every subsampling, and parameters from libaom
  grain tables, those libaom refuses refused: cv2's pixels carry the
  grain);
- screen content, each case's ``native._av1`` counts showing what it
  exercises: palettes (luma alone and with chroma, 2 to 8 colours,
  4:4:4 / 4:2:0 / 4:2:2 / 4:0:0, 64 and 128 superblocks, two tiles, sizes
  that are not a multiple of 8) and intra block copy (4:4:4 and 4:2:0,
  odd sizes, two tiles, vectors coded against the neighbours' stack and
  against the default one), written by ``aom_encode`` with libaom's
  screen tuning or by Pillow;
- grid primary items: 1x2, 2x2 and 3x1 grids of different tiles, cropped
  outputs, 4:2:0 seams (converted as one image), 4:4:4, 4:2:2, grey,
  32-bit output sizes, and the layouts libavif refuses;
- 10- and 12-bit streams from ``aom_encode`` at every subsampling and
  through every stage (deblocking, CDEF, restoration, superres, film
  grain, palettes, intra block copy, a grid), at 12 bits where the
  rounding differs, under every matrix and range cv2 reads;
- alpha items (libavif's route for cv2's BGRA, limited-range alpha) and
  premultiplied alpha (opaque, transparent, partly transparent; libyuv's
  and libavif's float un-premultiply), what cv2 refuses of them;
- image sequences: Pillow's, their first sample read from the colour
  track whatever the meta item, the edit list or the sync samples say,
  an alpha track, the sample tables and edit lists libavif refuses;
- a layered stream (several operating points), which the port still
  refuses, raising ``ImageError`` naming the path, "AVIF" and the tool
  while cv2 reads it;
- the tables: the committed ``csrc/av1_tables.h`` is what
  ``tools/av1_tables.py`` reads from libaom.so.3, where it is present.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image, features

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import formats, native
from objectdetectionpl_tpu_torch.tools import av1_tables, format_files
from objectdetectionpl_tpu_torch.tools.format_files import (
    av1c_bytes, avif_bytes, avif_grid_bytes, heif_box, screen_regions,
    screen_text)

pytestmark = pytest.mark.skipif(not features.check("avif"),
                                reason="Pillow without AVIF writes no file")

# every aom option of the tools the decoder reads, off
TOOLS = ("enable-cdef", "loopfilter-control", "enable-filter-intra",
         "enable-intra-edge-filter", "enable-cfl-intra",
         "enable-smooth-intra", "enable-paeth-intra", "enable-angle-delta",
         "enable-tx64", "enable-diagonal-intra", "enable-directional-intra",
         "enable-rect-tx", "enable-flip-idtx", "enable-rect-partitions",
         "enable-ab-partitions", "enable-1to4-partitions",
         "enable-restoration")
OFF = {t: "0" for t in TOOLS}


def _image(h, w, seed=0, smooth=True):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 4) % 256, (y * 5) % 256, (x + y) * 2 % 256], -1)
    return (img + rng.integers(0, 40, img.shape)).clip(0, 255).astype(
        np.uint8)


def _pillow(img, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(img).save(out, format="AVIF", **kw)
    return out.getvalue()


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


def _parts(data: bytes):
    """The primary item's AV1 stream and av1C body of a file."""
    boxes = list(formats._jp2_boxes(data, 0, len(data)))
    meta = [formats._avif_meta(data, a, s) for k, a, s in boxes
            if k == b"meta"][0]
    props = formats._avif_props(data, meta, meta["pitm"])
    at, stop = props[b"av1C"]
    return formats._avif_item_data(data, meta, meta["pitm"]), data[at:stop]


def _patch_colr(data: bytes, primaries=None, matrix=None, full=None):
    at = data.index(b"colrnclx") + 8
    out = bytearray(data)
    if primaries is not None:
        out[at:at + 2] = primaries.to_bytes(2, "big")
    if matrix is not None:
        out[at + 4:at + 6] = matrix.to_bytes(2, "big")
    if full is not None:
        out[at + 6] = 0x80 if full else 0
    return bytes(out)


def _box(stream, **kw) -> bytes:
    return avif_bytes(stream[0], 64, 40, stream[1], **kw)


@pytest.fixture(scope="module")
def stream():
    """An AV1 stream of a 64x40 image and its av1C, to box as we like."""
    obus, av1c = _parts(_pillow(_image(40, 64, smooth=False), quality=80))
    return obus, av1c


# ---------------------------------------------------------------------------
# the sniff

@pytest.mark.parametrize("major,slot", [(b"avif", None), (b"mif1", 0),
                                        (b"mif1", 10), (b"mif1", 118),
                                        (b"mif1", 119), (b"mif1", 120),
                                        (b"mif1", 300)])
def test_sniff_as_cv2(tmp_path, stream, major, slot):
    """cv2 finds its AVIF decoder by libavif's parse of the first 500
    bytes: an avif brand anywhere in ftyp (past 500 bytes too), but not a
    box header cut by the 500 bytes' end (slot 119: the ftyp ends 4 bytes
    before it, and cv2 calls the file no image)."""
    brands = (b"avif",) if slot is None else (b"mif1",) * slot + (b"avif",)
    data = _box(stream, major=major, brands=brands)
    path = _file(tmp_path, data)
    if slot == 119:
        assert formats.sniff(data[:formats.AVIF_HEAD]) == ""
        _both_refuse(path)
    else:
        assert formats.sniff(data[:formats.AVIF_HEAD]) == "AVIF"
        _same_as_cv2(path)
    no_brand = _box(stream, major=b"mif1", brands=(b"mif1", b"miaf"))
    assert formats.sniff(no_brand) == ""
    _both_refuse(_file(tmp_path, no_brand, "none.avif"))


# ---------------------------------------------------------------------------
# the container

CONTAINER = {
    "iloc_v1": dict(iloc_version=1),
    "iloc_v2_8byte": dict(iloc_version=2, sizes=(8, 8, 8, 4)),
    "iloc_v1_base_index": dict(iloc_version=1, sizes=(4, 8, 4, 8)),
    "idat": dict(iloc_version=1, idat=True),
    "extents": dict(extents=3),
    "extents_idat": dict(extents=3, iloc_version=2, idat=True),
    "ipma_15bit": dict(ipma_large=True),
    "ipma_v1": dict(ipma_version=1),
    "infe_v3": dict(infe_version=3),
    "hidden": dict(hidden=True),
    "item_7": dict(item_id=7),
    "no_pixi": dict(pixi=None),
    "no_colr": dict(nclx=None),
    "mif1_major": dict(major=b"mif1", brands=(b"mif1", b"avif")),
    "ignored_props": dict(extra_props=(
        (heif_box(b"irot", b"\x01"), True),
        (heif_box(b"imir", b"\x01"), True),
        (heif_box(b"clap", struct.pack(">8I", 32, 1, 20, 1, 0, 1, 0, 1)),
         True),
        (heif_box(b"colr", b"prof" + bytes(128)), True),
        (heif_box(b"pasp", struct.pack(">II", 1, 1)), True),
        (heif_box(b"clli", struct.pack(">HH", 1, 1)), True),
        (heif_box(b"a1op", b"\0"), True),
        (heif_box(b"lsel", b"\0\0"), True),
        (heif_box(b"a1lx", bytes(7)), False),
        (heif_box(b"zzzz", b"\0"), False))),
}


@pytest.mark.parametrize("case", sorted(CONTAINER))
def test_container_as_cv2(tmp_path, stream, case):
    _same_as_cv2(_file(tmp_path, _box(stream, **CONTAINER[case])))


def test_alpha_item_ignored(tmp_path, stream):
    """An auxl alpha item: cv2's IMREAD_COLOR pixels are the colour
    item's, so the port ignores it; premultiplied (prem) it refuses."""
    plain = _same_as_cv2(_file(tmp_path, _box(stream),
                               "plain.avif"))
    with_alpha = _file(tmp_path, _box(stream, alpha=stream))
    np.testing.assert_array_equal(_same_as_cv2(with_alpha), plain)
    prem = _file(tmp_path, _box(stream, alpha=stream,
                                      iref_extra=((b"prem", 1, 2),)),
                 "prem.avif")
    assert load_image_rgb(prem) is not None
    with pytest.raises(native.ImageError,
                       match=f"^{prem}: AVIF: premultiplied alpha"):
        native.decode_image(prem)


REFUSED_BY_CV2 = {
    "unknown_essential": dict(extra_props=((heif_box(b"zzzz", b"\0"),
                                            True),)),
    "mdcv_essential": dict(extra_props=((heif_box(b"mdcv", bytes(24)),
                                         True),)),
    "a1lx_essential": dict(extra_props=((heif_box(b"a1lx", bytes(7)),
                                         True),)),
    "pixi_10bit": dict(pixi=(10, 10, 10)),
    "idat_as_file": dict(idat=True),        # iloc v0: construction 0
    "avis_major": dict(major=b"avis"),      # libavif reads its tracks
}


@pytest.mark.parametrize("case", sorted(REFUSED_BY_CV2))
def test_container_refused_as_cv2(tmp_path, stream, case):
    _both_refuse(_file(tmp_path, _box(stream,
                                            **REFUSED_BY_CV2[case])))


def test_cut_files_refused_as_cv2(tmp_path, stream):
    data = _box(stream)
    for cut in list(range(16, len(data), len(data) // 23)) + [len(data) - 1]:
        _both_refuse(_file(tmp_path, data[:cut], f"cut{cut}.avif"))


def test_damaged_streams_as_cv2(tmp_path):
    """Bits flipped in the AV1 data of committed files: libaom refuses a
    tile whose padding after its last symbol is not a 1 bit then zeros
    (the specification's exit process), and so does the port; a file cv2
    reads reads the same."""
    rng = np.random.default_rng(11)
    for n in range(40):
        kind = format_files.AVIF_KINDS[n % len(format_files.AVIF_KINDS)]
        data = bytearray(format_files.COMMITTED[kind].read_bytes())
        start = data.index(b"mdat") + 24
        for at in rng.integers(start, len(data), rng.integers(1, 4)):
            data[at] ^= 1 << int(rng.integers(8))
        path = _file(tmp_path, bytes(data), f"d{n}.avif")
        if cv2.imread(path, cv2.IMREAD_COLOR) is None:
            _both_refuse(path)
        else:
            _same_as_cv2(path)


def test_ispe_not_the_frame_refused(tmp_path, stream):
    """cv2 writes the frame's rows into a buffer of ispe's size when the
    two differ (a deliberate difference: the port refuses, naming it)."""
    data = _box(stream).replace(
        struct.pack(">II", 64, 40), struct.pack(">II", 60, 40), 1)
    path = _file(tmp_path, data)
    assert load_image_rgb(path).shape == (40, 60, 3)
    with pytest.raises(native.ImageError, match="AVIF: ispe's 60x40 is not"):
        native.decode_image(path)


def _leb128(n: int) -> bytes:
    out = b""
    while True:
        out += bytes([n & 0x7F | (0x80 if n >> 7 else 0)])
        n >>= 7
        if not n:
            return out


def _obu(kind: int, body: bytes, ext=None, sized=True) -> bytes:
    head = bytes([kind << 3 | (4 if ext is not None else 0)
                  | (2 if sized else 0)])
    return head + (bytes([ext]) if ext is not None else b"") + (
        _leb128(len(body)) if sized else b"") + body


def _obu_bodies(stream: bytes) -> dict:
    """{OBU type: payload} of a stream of sized OBUs."""
    out, at = {}, 0
    while at < len(stream):
        kind = stream[at] >> 3 & 15
        at += 1 + (stream[at] >> 2 & 1)
        size, shift = 0, 0
        while True:
            size |= (stream[at] & 0x7F) << shift
            shift += 7
            at += 1
            if not stream[at - 1] & 0x80:
                break
        out[kind] = stream[at:at + size]
        at += size
    return out


CLL = _leb128(1) + bytes([0, 100, 0, 50, 0x80])    # HDR CLL metadata


def _level(s: bytes, level: int) -> bytes:
    """A reduced sequence header with seq_level_idx set to ``level``."""
    return bytes([s[0] & 0xF8 | level >> 2, s[1] & 0x3F | (level & 3) << 6]
                 ) + s[2:]
OBUS = {   # name: (the OBUs around the sequence header S and frame F,
           #        cv2 reads the file)
    "plain": (lambda s, f: _obu(1, s) + _obu(6, f), True),
    "temporal_delimiter": (lambda s, f: _obu(2, b"") + _obu(1, s)
                           + _obu(6, f), True),
    "extension_header": (lambda s, f: _obu(1, s, 0) + _obu(6, f, 0), True),
    "metadata": (lambda s, f: _obu(5, CLL) + _obu(1, s) + _obu(6, f), True),
    "after_the_frame": (lambda s, f: _obu(1, s) + _obu(6, f) + b"\0\0"
                        + _obu(2, b"") + _obu(1, s) + _obu(5, CLL), True),
    "zero_after_an_obu": (lambda s, f: _obu(1, s) + _obu(6, f) + _obu(2, b"")
                          + b"\0", False),
    "padding": (lambda s, f: _obu(1, s) + _obu(15, b"\x80") + _obu(6, f),
                True),
    "reserved": (lambda s, f: _obu(1, s) + _obu(9, b"") + _obu(6, f), True),
    "two_sequence_headers": (lambda s, f: _obu(1, s) + _obu(1, s)
                             + _obu(6, f), True),
    "padding_zero_last": (lambda s, f: _obu(1, s) + _obu(15, b"\0")
                          + _obu(6, f), False),
    "metadata_zero_last": (lambda s, f: _obu(1, s) + _obu(5, CLL[:-1] + b"\0")
                           + _obu(6, f), False),
    "unsized_frame": (lambda s, f: _obu(1, s) + _obu(6, f, sized=False),
                      False),
    "tile_list": (lambda s, f: _obu(1, s) + _obu(8, b"\x80") + _obu(6, f),
                  False),
    "delimiter_payload": (lambda s, f: _obu(2, b"\x80") + _obu(1, s)
                          + _obu(6, f), False),
    "no_sequence_header": (lambda s, f: _obu(6, f), False),
    # libaom's header checks: the trailing bits a 1 then zeros, zero
    # bytes after them, a defined level, still_picture under a reduced
    # header
    "sequence_header_zero_byte": (lambda s, f: _obu(1, s + b"\0")
                                  + _obu(6, f), True),
    "sequence_header_other_byte": (lambda s, f: _obu(1, s + b"\1")
                                   + _obu(6, f), False),
    "sequence_header_trailing_bits": (lambda s, f: _obu(1, s[:-1] + bytes(
        [s[-1] ^ 1])) + _obu(6, f), False),
    "level_9": (lambda s, f: _obu(1, _level(s, 9)) + _obu(6, f), True),
    "undefined_level_2": (lambda s, f: _obu(1, _level(s, 2)) + _obu(6, f),
                          False),
    "undefined_level_21": (lambda s, f: _obu(1, _level(s, 21))
                           + _obu(6, f), False),
    "reduced_header_video": (lambda s, f: _obu(1, bytes([s[0] & ~0x10])
                                               + s[1:]) + _obu(6, f), False),
}


@pytest.mark.parametrize("case", sorted(OBUS))
def test_obus_as_cv2(tmp_path, stream, case):
    """The OBUs libaom takes from libavif (the item's data alone: a
    sequence header in av1C's config OBUs only is no help, the last
    case)."""
    bodies = _obu_bodies(stream[0])
    make, reads = OBUS[case]
    av1c = stream[1][:4] + _obu(1, bodies[1])
    path = _file(tmp_path, avif_bytes(make(bodies[1], bodies[6]), 64, 40,
                                      av1c))
    if reads:
        _same_as_cv2(path)
    else:
        _both_refuse(path)


# ---------------------------------------------------------------------------
# the AV1 decoder, through the identity matrix and through libyuv

@pytest.mark.parametrize("tool", TOOLS)
def test_one_tool_on(tmp_path, tool):
    """Each tool alone over the tools-off base: 4:4:4 with matrix 0
    (identity, full range), so cv2 returns the decoded planes (G = Y,
    B = U, R = V)."""
    img = _image(72, 88, seed=TOOLS.index(tool), smooth=tool != "enable-cdef")
    data = _pillow(img, subsampling="4:4:4", quality=55,
                   advanced={**OFF, tool: "1"})
    _same_as_cv2(_file(tmp_path, _patch_colr(data, matrix=0, full=True)))


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (6, 1), (1, 6), (9, 17),
                                  (33, 65), (65, 33), (120, 160)])
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_subsampling_and_size(tmp_path, size, sub):
    h, w = size
    data = _pillow(_image(h, w, seed=h * w, smooth=h > 16), subsampling=sub,
                   quality=70)
    _same_as_cv2(_file(tmp_path, data))


STREAMS = {
    "tiles_sb128": dict(quality=60, tile_cols=1, autotiling=False,
                        advanced={"sb-size": "128"}),
    "tile_rows": dict(quality=60, tile_rows=1, tile_cols=1,
                      autotiling=False),
    "deltaq": dict(quality=70, advanced={"deltaq-mode": "1"}),
    "aq_mode": dict(quality=70, advanced={"aq-mode": "1"}),
    "chroma_deltaq": dict(quality=70, subsampling="4:4:4",
                          advanced={"enable-chroma-deltaq": "1"}),
    "qm": dict(quality=80, advanced={"enable-qm": "1"}),
    "reduced_tx_set": dict(quality=70, advanced={"reduced-tx-type-set":
                                                 "1"}),
    "lossless": dict(quality=100, subsampling="4:4:4"),
    "q0": dict(quality=0),
    "q95": dict(quality=95),
    "speed10": dict(quality=60, speed=10),
    "screen_content": dict(quality=90, subsampling="4:4:4",
                           advanced={"enable-palette": "0",
                                     "enable-intrabc": "0"}),
}


def _screen():
    """Blocks of four colours: aom turns on its screen content tools."""
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 4, (15, 20)).repeat(8, 0).repeat(8, 1)
    return rng.integers(0, 256, (4, 3)).astype(np.uint8)[lab]


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_stream_kinds(tmp_path, case):
    if case == "screen_content":
        img = _screen()
    else:
        img = _image(120, 160, seed=len(case), smooth=case != "q95")
    _same_as_cv2(_file(tmp_path, _pillow(img, **STREAMS[case])))


def test_default_files(tmp_path):
    """cv2.imwrite's default AVIF (CDEF, quantizer matrices, delta q) and
    Pillow's default at quality 50, 80 and 95, at 160x120 and 97x61."""
    for h, w in ((120, 160), (61, 97)):
        img = _image(h, w, seed=w)
        path = tmp_path / f"cv2_{w}.avif"
        assert cv2.imwrite(str(path), img[..., ::-1])
        _same_as_cv2(str(path))
        for q in (None, 50, 80, 95):
            kw = {} if q is None else {"quality": q}
            _same_as_cv2(_file(tmp_path, _pillow(img, **kw), f"p{q}_{w}.avif"))


# ---------------------------------------------------------------------------
# the stages after CDEF: loop restoration, superres, film grain

def _info(data: bytes) -> dict:
    return native.av1_probe(_parts(data)[0])


def _types(info: dict):
    return (info["restoration_y"], info["restoration_u"],
            info["restoration_v"])


def _lr_image(kind: str) -> np.ndarray:
    """128x160: noise, or a gradient with small or large noise."""
    rng = np.random.default_rng(1)
    if kind == "noise":
        return rng.integers(0, 256, (128, 160, 3)).astype(np.uint8)
    y, x = np.mgrid[0:128, 0:160]
    img = np.stack([(x * 4) % 256, (y * 5) % 256, (x + y) * 2 % 256], -1)
    amp = 40 if kind == "smooth" else 120
    return (img + rng.integers(0, amp, img.shape)).clip(0, 255).astype(
        np.uint8)


def _quadrants(h: int, w: int, subsampling: str) -> list:
    """Planes whose luma quadrants differ (a gradient, stripes, a flat
    area, noise): units that want different restoration."""
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:h, 0:w]
    luma = ((x * 3 + y * 2) % 256 + rng.integers(0, 60, (h, w))).clip(
        0, 255).astype(np.uint8)
    hh, hw = h // 2, w // 2
    luma[:hh, hw:] = ((np.arange(w - hw) // 2 % 2) * 200 + 20)[None, :]
    luma[hh:, :hw] = 128 + rng.integers(-3, 4, (h - hh, hw))
    luma[hh:, hw:] = rng.integers(0, 256, (h - hh, w - hw))
    return [luma] + _chroma(rng, h, w, subsampling)


def _stripes(h: int, w: int, subsampling: str) -> list:
    """Planes whose luma is vertical stripes two pixels wide, the chroma
    drawn after three draws that only advance the generator."""
    rng = np.random.default_rng(1)
    for shape in ((h, w), (h, w // 2), (h, w // 2)):
        rng.integers(0, 4, shape)
    luma = np.tile(((np.arange(w) // 2 % 2) * 200 + 20).astype(np.uint8),
                   (h, 1))
    return [luma] + _chroma(rng, h, w, subsampling)


def _chroma(rng, h, w, subsampling):
    if subsampling == "4:0:0":
        return []
    sx, sy = {"4:2:0": (1, 1), "4:2:2": (1, 0), "4:4:4": (0, 0)}[subsampling]
    return [rng.integers(60, 200, ((h + sy) >> sy, (w + sx) >> sx)).astype(
        np.uint8) for _ in range(2)]


def _aom(planes, subsampling, **kw) -> bytes:
    """``aom_encode``'s OBUs boxed as an AVIF (the av1C made for them)."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    obus = format_files.aom_encode(planes, subsampling, **kw)
    h, w = planes[0].shape
    return avif_bytes(obus, w, h, format_files.av1c_bytes(subsampling))


# name: (subsampling, superblock, quality, image, the frame's restoration
# types of Y, U, V: 1 Wiener, 2 self-guided), Pillow at speed 2
LR_CASES = {
    "sgr_y_wiener_uv_420_sb64": ("4:2:0", 64, 30, "noise", (2, 1, 1)),
    "wiener_444_sb128": ("4:4:4", 128, 30, "noise", (1, 1, 1)),
    "sgr_444_sb64": ("4:4:4", 64, 50, "smooth", (2, 2, 2)),
    "sgr_u_420_sb128": ("4:2:0", 128, 30, "smooth", (0, 2, 0)),
    "wiener_400_sb64": ("4:0:0", 64, 30, "rough", (1, 0, 0)),
    "sgr_400_sb128": ("4:0:0", 128, 50, "smooth", (2, 0, 0)),
}


# switchable units (type 3) from libaom 3.6 over 64x256: two 128-pixel
# units a row; (planes, subsampling, cpu-used, cq-level, the types)
SWITCHABLE = {"switchable_v_444": (_quadrants, "4:4:4", 0, 40, (2, 2, 3)),
              "switchable_y_420": (_stripes, "4:2:0", 1, 50, (3, 1, 1))}


@pytest.mark.parametrize("case", sorted(LR_CASES) + sorted(SWITCHABLE))
def test_loop_restoration_as_cv2(tmp_path, case):
    """Each case's restoration types as its name says."""
    if case in SWITCHABLE:
        planes, sub, cpu, cq, want = SWITCHABLE[case]
        data = _aom(planes(64, 256, sub), sub,
                    options={"enable-restoration": 1, "cpu-used": cpu,
                             "cq-level": cq, "sb-size": "64",
                             "enable-palette": 0, "enable-intrabc": 0})
        sb = 64
    else:
        sub, sb, quality, kind, want = LR_CASES[case]
        data = _pillow(_lr_image(kind), subsampling=sub, quality=quality,
                       speed=2, advanced={"enable-restoration": "1",
                                          "sb-size": str(sb)})
    info = _info(data)
    assert (_types(info), info["superblock"]) == (want, sb)
    _same_as_cv2(_file(tmp_path, data))


# name: (height, width, subsampling, denominator, aom options)
SUPERRES = {
    "d9_420": (64, 96, "4:2:0", 9, {}),
    "d12_420_lr": (64, 96, "4:2:0", 12, {}),
    "d16_420_lr": (128, 160, "4:2:0", 16, {}),
    "d13_444_odd_lr": (61, 157, "4:4:4", 13, {}),
    "d11_422_odd": (37, 75, "4:2:2", 11, {}),
    "d14_400_odd_lr": (45, 99, "4:0:0", 14, {}),
    "d16_420_tiles2_lr": (64, 288, "4:2:0", 16, {"tile-columns": 1}),
    "d9_444_odd_tiles2": (48, 153, "4:4:4", 9, {"tile-columns": 1}),
}


@pytest.mark.parametrize("case", sorted(SUPERRES))
def test_superres_as_cv2(tmp_path, case):
    """Superres key frames from libaom 3.6 (fixed denominator): the coded
    width ``(W * 8 + d / 2) / d``, upscaled per tile column (two columns:
    an inner one of at least 128 coded pixels, as libaom asks under
    superres), restoration on the upscaled planes where asked."""
    h, w, sub, denom, options = SUPERRES[case]
    rng = np.random.default_rng(denom)
    y, x = np.mgrid[0:h, 0:w]
    luma = ((x * 3 + y * 2) % 256 + rng.integers(0, 60, (h, w))).clip(
        0, 255).astype(np.uint8)
    data = _aom([luma] + _chroma(rng, h, w, sub), sub, superres=denom,
                options={"cq-level": 30, "cpu-used": 4, "sb-size": "64",
                         "enable-restoration": int("lr" in case), **options})
    info = _info(data)
    assert info["superres_denom"] == denom and info["width"] == w
    assert info["coded_width"] == (w * 8 + denom // 2) // denom
    assert info["tile_cols"] == (2 if "tiles2" in case else 1)
    assert any(_types(info)) == ("lr" in case)
    _same_as_cv2(_file(tmp_path, data))


# (libaom's film-grain-test vector, subsampling, height, width)
GRAIN = [(1, "4:2:0", 64, 96), (2, "4:4:4", 37, 53), (3, "4:2:2", 70, 33),
         (5, "4:0:0", 45, 61), (8, "4:2:0", 33, 47), (10, "4:2:2", 64, 96),
         (13, "4:4:4", 61, 97), (16, "4:2:0", 128, 160)]


@pytest.mark.parametrize("test,sub,h,w", GRAIN)
def test_film_grain_as_cv2(tmp_path, test, sub, h, w):
    """libaom's film grain test vectors (Pillow's encoder): cv2's pixels
    carry the grain libaom adds (av1_add_film_grain, odd sizes padded),
    which the port synthesizes as the specification does."""
    data = _pillow(_image(h, w, seed=test), subsampling=sub, quality=60,
                   advanced={"film-grain-test": str(test)})
    assert _info(data)["apply_grain"] == 1
    _same_as_cv2(_file(tmp_path, data))


def test_committed_stage_fixtures():
    """``format_files.avif_stage_files`` is the recipe of the committed
    AVIFs of the stages after CDEF (``chip_smoke.py formats`` serves
    them): the same bytes again, each exercising what its name says."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    want = {"avif_wiener": ((1, 1, 1), 8, 0), "avif_sgrproj": ((2, 0, 2), 8, 0),
            "avif_superres": ((2, 2, 1), 16, 0),
            "avif_film_grain": ((0, 0, 0), 8, 1)}
    files = format_files.avif_stage_files()
    assert sorted(files) == sorted(want)
    for kind, data in files.items():
        assert format_files.COMMITTED[kind].read_bytes() == data, kind
        info = _info(data)
        assert (_types(info), info["superres_denom"],
                info["apply_grain"]) == want[kind], kind
    assert _info(files["avif_superres"])["tile_cols"] == 2
    assert _info(files["avif_sgrproj"])["superblock"] == 128


def _grain_table(y, cb, cr, lag=1, from_luma=0, overlap=1) -> str:
    """A libaom film grain table (grain_table.c's text form): one entry
    for every frame, these scaling points, an auto-regressive lag."""
    n = 2 * lag * (lag + 1)
    pts = lambda p: f"{len(p)}" + "".join(f" {a} {b}" for a, b in p)
    return "\n".join([
        "filmgrn1", "E 0 9223372036854775807 1 4321 1",
        f"\tp {lag} 7 0 11 {from_luma} {overlap} 120 200 270 140 180 240",
        f"\tsY {pts(y)}", f"\tsCb {pts(cb)}", f"\tsCr {pts(cr)}",
        "\tcY" + "".join(f" {(-1) ** i * (3 + i)}" for i in range(n)),
        "\tcCb" + "".join(f" {2 - i}" for i in range(n + 1)),
        "\tcCr" + "".join(f" {i - 3}" for i in range(n + 1))]) + "\n"


Y3 = [(0, 20), (128, 70), (255, 30)]
C2 = [(0, 30), (200, 50)]
# (subsampling, table keywords, cv2 reads the file)
GRAIN_TABLES = {
    "from_luma_lag3_420": ("4:2:0", dict(y=Y3, cb=[], cr=[], lag=3,
                                          from_luma=1), True),
    "no_overlap_lag0_444": ("4:4:4", dict(y=Y3, cb=C2, cr=C2, lag=0,
                                           overlap=0), True),
    "luma_only_422": ("4:2:2", dict(y=Y3, cb=[], cr=[], lag=2), True),
    "chroma_only_444": ("4:4:4", dict(y=[], cb=C2, cr=[(10, 60)]), True),
    "grey_400": ("4:0:0", dict(y=Y3, cb=[], cr=[]), True),
    "luma_points_repeat": ("4:2:0", dict(y=[(0, 20), (128, 60), (128, 30)],
                                         cb=C2, cr=C2), False),
    "cb_points_fall": ("4:4:4", dict(y=Y3, cb=[(40, 30), (20, 50)],
                                     cr=C2), False),
    "cb_without_cr_420": ("4:2:0", dict(y=Y3, cb=C2, cr=[]), False),
}


@pytest.mark.parametrize("case", sorted(GRAIN_TABLES))
def test_film_grain_tables_as_cv2(tmp_path, case):
    """Film grain parameters written by libaom 3.6 from a grain table
    (``film-grain-table``): chroma scaled from luma, no overlap, lags 0
    to 3, luma or chroma alone, grey; and the parameters libaom refuses
    (scaling points that do not increase, 4:2:0 points for one chroma
    plane only), which the port refuses too."""
    sub, table, reads = GRAIN_TABLES[case]
    (tmp_path / "grain.tbl").write_text(_grain_table(**table))
    rng = np.random.default_rng(len(case))
    y, x = np.mgrid[0:45, 0:61]
    luma = ((x * 4 + y * 3) % 256 + rng.integers(0, 40, (45, 61))).clip(
        0, 255).astype(np.uint8)
    data = _aom([luma] + _chroma(rng, 45, 61, sub), sub,
                options={"cq-level": 30, "cpu-used": 6,
                         "film-grain-table": str(tmp_path / "grain.tbl")})
    path = _file(tmp_path, data)
    if reads:
        assert _info(data)["apply_grain"] == 1
        _same_as_cv2(path)
    else:
        _both_refuse(path)
        with pytest.raises(formats.FormatError, match="film grain"):
            _info(data)


# ---------------------------------------------------------------------------
# the colour conversions

@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_matrices_and_ranges(tmp_path, sub):
    """libyuv's constants (matrices 1, 2, 5, 6, 9, and 12 under primaries
    1, 2, 5, 6, 9) after its bilinear chroma; libavif's float path with
    its own bilinear chroma for the rest cv2 reads (0 at 4:4:4, 4, 7, 8 in
    full range, 12 under other primaries, 15); the grey plane for 4:0:0
    whatever the matrix; what cv2 refuses is refused."""
    base = _pillow(_image(41, 53, seed=5, smooth=False), subsampling=sub,
                   quality=90)
    for matrix in range(17):
        for full in (True, False):
            path = _file(tmp_path, _patch_colr(base, matrix=matrix,
                                               full=full),
                         f"m{matrix}_{full}.avif")
            if cv2.imread(path, cv2.IMREAD_COLOR) is None:
                _both_refuse(path)
            else:
                _same_as_cv2(path)
    for primaries in (0, 1, 2, 4, 5, 6, 9, 10, 12, 22, 255):
        _same_as_cv2(_file(tmp_path, _patch_colr(base, primaries, 12),
                           f"p{primaries}.avif"))


# ---------------------------------------------------------------------------
# screen content: palettes and intra block copy

def _counts(data: bytes) -> dict:
    """What the primary item's stream used (``native._av1``'s counts)."""
    return native._av1(_parts(data)[0])[1]


def _screen_aom(rgb, sub, **options) -> bytes:
    """``aom_encode`` with libaom's screen tuning, boxed as an AVIF."""
    planes = format_files._yuv(rgb, sub)[:1 if sub == "4:0:0" else 3]
    return _aom(planes, sub, options={"tune-content": "screen",
                                      "cpu-used": 4, **options})


# name: (subsampling, height, width, seed, aom options, chroma palettes
# expected); the image is ``screen_regions``' (grey where no chroma
# palette is expected)
PALETTE = {
    "444_y_uv": ("4:4:4", 120, 160, 1, {}, True),
    "420_y_uv": ("4:2:0", 120, 160, 1, {}, True),
    "422_y_uv_odd": ("4:2:2", 61, 97, 4, {}, True),
    "400_y": ("4:0:0", 120, 160, 1, {}, False),
    "420_y_only": ("4:2:0", 120, 160, 2, {}, False),
    "420_sb128_odd": ("4:2:0", 117, 157, 2, {"sb-size": "128"}, True),
    "444_two_tiles": ("4:4:4", 96, 160, 0, {"tile-columns": 1}, True),
    "420_cq40_odd": ("4:2:0", 45, 83, 5, {"cq-level": 40}, True),
}


@pytest.mark.parametrize("case", sorted(PALETTE))
def test_palette_as_cv2(tmp_path, case):
    """Palettes of 2 to 8 colours (sizes and colours coded or taken from
    the neighbours' cache, the colour index map read in anti-diagonal
    order and extended past the frame's edge): each case's blocks with a
    Y and a UV palette counted."""
    sub, h, w, seed, options, uv = PALETTE[case]
    rgb = screen_regions(h, w, seed)
    if not uv:
        rgb = np.repeat(rgb[..., 1:2], 3, 2)
    data = _screen_aom(rgb, sub, **{"cq-level": 20, "enable-intrabc": 0,
                                    **options})
    info = _counts(data)
    assert info["palette_y_blocks"] > 0
    assert (info["palette_uv_blocks"] > 0) == uv
    if case == "444_y_uv":
        assert info["palette_sizes"] == list(range(2, 9))
    if "tiles" in case:
        assert _info(data)["tile_cols"] == 2
    if "sb128" in case:
        assert _info(data)["superblock"] == 128
    _same_as_cv2(_file(tmp_path, data))


def test_palette_pillow_as_cv2(tmp_path):
    """Pillow's encoder (its own libaom) with palettes on, the file cv2
    reads and the port used to refuse."""
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 5, (12, 16)).repeat(8, 0).repeat(8, 1)
    screen = rng.integers(0, 256, (5, 3)).astype(np.uint8)[lab]
    data = _pillow(screen, subsampling="4:4:4", quality=90,
                   advanced={"enable-palette": "1"})
    assert _counts(data)["palette_y_blocks"] > 0
    _same_as_cv2(_file(tmp_path, data))


# name: (subsampling, height, width, seed, aom options): pages of text
# (``screen_text``) at libaom's screen tuning, palettes off but where
# named; two tile columns need three rows of superblocks (the copy
# keeps 256 samples behind the block it predicts)
INTRABC = {
    "444": ("4:4:4", 120, 160, 0, {}),
    "420": ("4:2:0", 120, 160, 0, {}),
    "444_odd": ("4:4:4", 119, 157, 1, {}),
    "420_odd": ("4:2:0", 117, 157, 0, {}),
    "420_two_tiles": ("4:2:0", 192, 160, 0, {"tile-columns": 1}),
    "420_cq10": ("4:2:0", 120, 160, 2, {"cq-level": 10}),
    "420_with_palettes": ("4:2:0", 120, 160, 1, {"enable-palette": 1}),
    "420_reduced_tx_set": ("4:2:0", 120, 160, 1,
                           {"reduced-tx-type-set": 1}),
}


@pytest.mark.parametrize("case", sorted(INTRABC))
def test_intrabc_as_cv2(tmp_path, case):
    """Intra block copy: each case's copied blocks counted, among them
    those whose vector was coded against the neighbours' stack and those
    coded against the default vector; the frame's filters are off."""
    sub, h, w, seed, options = INTRABC[case]
    data = _screen_aom(screen_text(h, w, seed), sub,
                       **{"cq-level": 30, "enable-palette": 0, **options})
    probe, info = _info(data), _counts(data)
    assert probe["intrabc"] == probe["screen_content_tools"] == 1
    assert info["intrabc_blocks"] > info["intrabc_default_dv"] > 0
    if "palettes" in case:
        assert info["palette_y_blocks"] > 0
    if "tiles" in case:
        assert probe["tile_cols"] == 2
    _same_as_cv2(_file(tmp_path, data))


def test_intrabc_pillow_as_cv2(tmp_path):
    """Pillow's encoder (its own libaom) with palettes off: the file cv2
    reads and the port used to refuse."""
    data = _pillow(_screen(), subsampling="4:4:4", quality=90,
                   advanced={"enable-palette": "0"})
    assert _counts(data)["intrabc_blocks"] > 0
    _same_as_cv2(_file(tmp_path, data))


def test_committed_screen_fixtures():
    """``format_files.avif_screen_files`` is the recipe of the committed
    screen-content AVIFs (``chip_smoke.py formats`` serves them): the
    same bytes again, each exercising what its name says."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    files = format_files.avif_screen_files()
    assert sorted(files) == ["avif_grid_cropped", "avif_intrabc",
                             "avif_palette_420", "avif_palette_444"]
    for kind, data in files.items():
        assert format_files.COMMITTED[kind].read_bytes() == data, kind
    for kind in ("avif_palette_444", "avif_palette_420"):
        info = _counts(files[kind])
        assert info["palette_y_blocks"] and info["palette_uv_blocks"], kind
    assert _info(files["avif_palette_420"])["superblock"] == 128
    assert _counts(files["avif_intrabc"])["intrabc_blocks"] > 0


# ---------------------------------------------------------------------------
# grid primary items

def _tiles(n, h, w, sub="4:2:0", seed=0):
    """n different h x w AV1 streams (Pillow's) and their av1C."""
    parts = [_parts(_pillow(_image(h, w, seed=seed + i, smooth=False),
                            subsampling=sub, quality=70)) for i in range(n)]
    return [p[0] for p in parts], parts[0][1]


# name: (rows, columns, tile height, width, subsampling, output or None)
GRID = {
    "1x2_420": (1, 2, 64, 64, "4:2:0", None),
    "2x2_420": (2, 2, 64, 64, "4:2:0", None),
    "3x1_420": (3, 1, 64, 64, "4:2:0", None),
    "2x2_420_cropped": (2, 2, 64, 64, "4:2:0", (100, 90)),
    "2x2_444_odd_cropped": (2, 2, 67, 65, "4:4:4", (121, 99)),
    "2x2_422_cropped": (2, 2, 64, 66, "4:2:2", (130, 101)),
    "1x2_400": (1, 2, 64, 64, "4:0:0", None),
}


@pytest.mark.parametrize("case", sorted(GRID))
def test_grid_as_cv2(tmp_path, case):
    """A grid of different tiles, cropped to its output size, converted
    as one image: at 4:2:0 the chroma upsampling reads across the seams,
    so converting each tile alone would differ."""
    rows, cols, th, tw, sub, output = GRID[case]
    streams, av1c = _tiles(rows * cols, th, tw, sub, seed=len(case))
    data = avif_grid_bytes(streams, tw, th, av1c, rows, cols, output=output)
    got = _same_as_cv2(_file(tmp_path, data))
    if case == "2x2_420":
        tiles = [_same_as_cv2(_file(tmp_path, avif_bytes(s, tw, th, av1c),
                                    f"t{i}.avif"))
                 for i, s in enumerate(streams)]
        per_tile = np.concatenate([np.concatenate(tiles[:2], 1),
                                   np.concatenate(tiles[2:], 1)], 0)
        assert not np.array_equal(per_tile, got)


def test_grid_32bit_sizes_as_cv2(tmp_path):
    """Flag bit 0 of the ImageGrid: 32-bit output sizes."""
    streams, av1c = _tiles(4, 64, 64)
    body = bytes([0, 1, 1, 1]) + struct.pack(">II", 128, 120)
    _same_as_cv2(_file(tmp_path, avif_grid_bytes(
        streams, 64, 64, av1c, 2, 2, body=body, ispe=(128, 120))))


def _grid_refused():
    """name: avif_grid_bytes' arguments of a grid libavif refuses."""
    t, av1c = _tiles(4, 64, 64)
    small, small_c = _tiles(4, 32, 32)
    odd, odd_c = _tiles(2, 65, 64)
    tall, _ = _tiles(1, 72, 64, seed=9)
    t444, c444 = _tiles(1, 64, 64, "4:4:4", seed=7)
    return {
        "too_few_tiles": (t[:3], 64, 64, av1c, 2, 2, {}),
        "too_many_tiles": (t[:3], 64, 64, av1c, 1, 2, {}),
        "tiles_under_64": (small, 32, 32, small_c, 2, 2, {}),
        "odd_tile_height_420": (odd, 64, 65, odd_c, 2, 1, {}),
        "odd_output_420": (t, 64, 64, av1c, 2, 2, {"output": (127, 128)}),
        "output_past_the_tiles": (t, 64, 64, av1c, 2, 2,
                                  {"output": (130, 128)}),
        "last_column_outside": (t, 64, 64, av1c, 2, 2,
                                {"output": (64, 128)}),
        "zero_output": (t, 64, 64, av1c, 2, 2, {"output": (0, 128)}),
        "tiles_of_two_sizes": (t[:3] + tall, 64, 64, av1c, 2, 2,
                               {"tile_ispe": [(64, 64)] * 3 + [(64, 72)]}),
        "tiles_of_two_subsamplings": (t[:3] + t444, 64, 64, av1c, 2, 2, {}),
        "av1c_differ": (t[:3] + t444, 64, 64, av1c, 2, 2,
                        {"tile_av1c": [av1c] * 3 + [c444]}),
        "tile_without_ispe": (t, 64, 64, av1c, 2, 2,
                              {"tile_ispe": [(64, 64)] * 3 + [None]}),
        "tile_not_av01": (t, 64, 64, av1c, 2, 2, {"tile_kind": b"hvc1"}),
        "version_1": (t, 64, 64, av1c, 2, 2, {
            "body": bytes([1, 0, 1, 1]) + struct.pack(">HH", 128, 128)}),
        "body_too_long": (t, 64, 64, av1c, 2, 2, {
            "body": bytes([0, 0, 1, 1]) + struct.pack(">HH", 128, 128)
            + b"\0"}),
        "ispe_not_the_output": (t, 64, 64, av1c, 2, 2,
                                {"ispe": (120, 128)}),
    }


GRID_REFUSED = sorted(("too_few_tiles", "too_many_tiles", "tiles_under_64",
                       "odd_tile_height_420", "odd_output_420",
                       "output_past_the_tiles", "last_column_outside",
                       "zero_output", "tiles_of_two_sizes",
                       "tiles_of_two_subsamplings", "av1c_differ",
                       "tile_without_ispe", "tile_not_av01", "version_1",
                       "body_too_long", "ispe_not_the_output"))


@pytest.mark.parametrize("case", GRID_REFUSED)
def test_grid_refused_as_cv2(tmp_path, case):
    """The grids libavif refuses (cv2 then reads no image): a tile count
    unlike rows x columns; MIAF's tile rules (64x64 at least, even where
    chroma is subsampled); an output the tiles do not cover, or whose
    last row or column of tiles lies outside it; tiles of two sizes or
    subsamplings, or whose av1C differ; a tile without ispe, or not av01;
    an ImageGrid of another version or with bytes after it; a grid whose
    ispe is not its output size."""
    *args, kw = _grid_refused()[case]
    path = _file(tmp_path, avif_grid_bytes(*args, **kw))
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None
    with pytest.raises(native.ImageError, match=f"^{path}: AVIF: "):
        native.decode_image(path)


def test_grid_tile_ispe_not_its_frame_refused(tmp_path):
    """A tile whose ispe is not its AV1 frame's size: libavif scales the
    frame to the ispe, the port refuses, naming it (a deliberate
    difference, as for a single item's ispe)."""
    t, av1c = _tiles(3, 64, 64)
    tall, _ = _tiles(1, 72, 64, seed=9)
    path = _file(tmp_path, avif_grid_bytes(t + tall, 64, 64, av1c, 2, 2))
    assert load_image_rgb(path).shape == (128, 128, 3)
    with pytest.raises(native.ImageError,
                       match="AVIF: grid tile 4's ispe 64x64 is not its AV1"):
        native.decode_image(path)


# ---------------------------------------------------------------------------
# 10 and 12 bits

def _deep(planes, sub, depth, nclx=(1, 13, 6, 1), superres=None,
          **options) -> bytes:
    """``aom_encode`` of 8-bit planes deepened to ``depth``
    (``format_files.deepen``: high bits replicated) or of planes already
    at it, boxed with an av1C and pixi of that depth."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    if planes[0].dtype == np.uint8:
        planes = format_files.deepen(planes, depth)
    obus = format_files.aom_encode(planes, sub, superres=superres,
                                   bit_depth=depth,
                                   options={"cpu-used": 4, **options})
    h, w = planes[0].shape
    return avif_bytes(obus, w, h, av1c_bytes(sub, depth), nclx=nclx,
                      pixi=(depth,) * len(planes))


def _planes_at(h, w, sub, depth, seed=0) -> list:
    """A gradient with noise in every bit of ``depth``, and random
    chroma."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    y, x = np.mgrid[0:h, 0:w]
    luma = ((x * 5 + y * 3) * (top + 1) // 256 + rng.integers(
        0, top // 6, (h, w))) % (top + 1)
    planes = [luma.astype(np.uint16)]
    if sub != "4:0:0":
        sx, sy = int(sub != "4:4:4"), int(sub == "4:2:0")
        planes += [rng.integers(0, top + 1, ((h + sy) >> sy, (w + sx) >> sx))
                   .astype(np.uint16) for _ in range(2)]
    return planes


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_depth_and_subsampling_as_cv2(tmp_path, depth, sub):
    """10- and 12-bit streams (profile 0 / 1 / 2 at 10 bits, 2 at 12) at
    an odd size through deblocking and CDEF: libaom's high-bitdepth
    route, then libyuv's planes cut to 8 bits (4:0:0: cv2's rounded
    convertTo)."""
    data = _deep(_planes_at(37, 53, sub, depth, seed=depth), sub, depth,
                 **{"cq-level": 35})
    assert _info(data)["bit_depth"] == depth
    _same_as_cv2(_file(tmp_path, data))


def _lr_planes(kind: str, sub: str) -> list:
    if kind in ("noise", "smooth"):
        return format_files._yuv(_lr_image(kind)[:64, :128], sub)
    return (_quadrants if kind == "quadrants" else _stripes)(64, 128, sub)


# name: (8-bit planes, subsampling, depth, aom options, superres
# denominator, the native.av1_probe fields the stream shows); where the
# rounding differs at 12 bits (Wiener's InterRound, CDEF's and the
# deblocking's shifts, grain's scaling) a 12-bit case too
STAGES = {
    "deblock_cdef_420_10": (lambda: _quadrants(64, 96, "4:2:0"), "4:2:0",
                            10, {"cq-level": 45}, None, {}),
    "deblock_cdef_444_12": (lambda: _quadrants(64, 96, "4:4:4"), "4:4:4",
                            12, {"cq-level": 45}, None, {}),
    "wiener_y_420_10": (lambda: _lr_planes("noise", "4:2:0"), "4:2:0", 10,
                        {"cq-level": 50}, None, {"restoration_y": 1}),
    "wiener_y_444_12": (lambda: _lr_planes("quadrants", "4:4:4"), "4:4:4",
                        12, {"cq-level": 50}, None, {"restoration_y": 1}),
    "sgrproj_y_420_10": (lambda: _lr_planes("quadrants", "4:2:0"), "4:2:0",
                         10, {"cq-level": 30}, None, {"restoration_y": 2}),
    "sgrproj_uv_420_12": (lambda: _lr_planes("stripes", "4:2:0"), "4:2:0",
                          12, {"cq-level": 10}, None,
                          {"restoration_u": 2, "restoration_v": 2}),
    "superres_d12_420_10": (lambda: _quadrants(64, 96, "4:2:0"), "4:2:0",
                            10, {"cq-level": 30}, 12, {"superres_denom": 12}),
    "superres_d13_444_odd_12": (lambda: _quadrants(61, 157, "4:4:4"),
                                "4:4:4", 12, {"cq-level": 30}, 13,
                                {"superres_denom": 13}),
    "film_grain1_420_10": (lambda: format_files._yuv(
        _image(64, 96, seed=1), "4:2:0"), "4:2:0", 10,
        {"cq-level": 30, "film-grain-test": 1}, None, {"apply_grain": 1}),
    "film_grain10_422_odd_12": (lambda: format_files._yuv(
        _image(37, 53, seed=10), "4:2:2"), "4:2:2", 12,
        {"cq-level": 30, "film-grain-test": 10}, None, {"apply_grain": 1}),
    "film_grain16_400_12": (lambda: format_files._yuv(
        _image(45, 61, seed=16), "4:2:0")[:1], "4:0:0", 12,
        {"cq-level": 30, "film-grain-test": 16}, None, {"apply_grain": 1}),
}


@pytest.mark.parametrize("case", sorted(STAGES))
def test_depth_stages_as_cv2(tmp_path, case):
    """Each stage after the tiles at 10 bits, and at 12 where its
    rounding differs: deblocking and CDEF (strengths, limits and damping
    shifted by BitDepth - 8), Wiener (InterRound 5 / 9 at 12 bits) and
    self-guided units (the variance at 8 bits), superres, film grain
    (the interpolated scaling look-up, the shifted ranges)."""
    planes, sub, depth, options, denom, want = STAGES[case]
    data = _deep(planes(), sub, depth, superres=denom, **{
        "enable-restoration": 1, "cpu-used": 1, "sb-size": "64", **options})
    info = _info(data)
    assert info["bit_depth"] == depth
    assert {k: info[k] for k in want} == want
    _same_as_cv2(_file(tmp_path, data))


# name: (image, subsampling, depth, aom options); libaom's screen tuning
DEPTH_SCREEN = {
    "palette_444_10": (lambda: screen_regions(96, 128, 4), "4:4:4", 10,
                       {"cq-level": 20, "enable-intrabc": 0}),
    "palette_420_12": (lambda: screen_regions(70, 99, 5), "4:2:0", 12,
                       {"cq-level": 20, "enable-intrabc": 0}),
    "intrabc_420_10": (lambda: screen_text(120, 160, 3), "4:2:0", 10,
                       {"cq-level": 40, "enable-palette": 0}),
    "intrabc_444_12": (lambda: screen_text(120, 160, 3), "4:4:4", 12,
                       {"cq-level": 40, "enable-palette": 0}),
}


@pytest.mark.parametrize("case", sorted(DEPTH_SCREEN))
def test_depth_screen_content_as_cv2(tmp_path, case):
    """Palettes (colours of ``depth`` bits, delta coded) and intra block
    copy (its bilinear copy rounded by 5 then 9 bits at 12) at depth."""
    image, sub, depth, options = DEPTH_SCREEN[case]
    data = _deep(format_files._yuv(image(), sub), sub, depth,
                 **{"tune-content": "screen", **options})
    counts = _counts(data)
    if "palette" in case:
        assert counts["palette_y_blocks"] and counts["palette_uv_blocks"]
    else:
        assert counts["intrabc_blocks"] > 0
    _same_as_cv2(_file(tmp_path, data))


def test_depth_grid_as_cv2(tmp_path):
    """A 2x2 grid of 10-bit 4:2:0 tiles cropped to 120x100: assembled at
    10 bits, converted as one image."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    tiles = [format_files.aom_encode(_planes_at(64, 64, "4:2:0", 10, seed=k),
                                     "4:2:0", bit_depth=10,
                                     options={"cq-level": 30, "cpu-used": 4})
             for k in range(4)]
    _same_as_cv2(_file(tmp_path, avif_grid_bytes(
        tiles, 64, 64, av1c_bytes("4:2:0", 10), 2, 2, output=(120, 100),
        depth=10)))


# the colr boxes tried at depth: libyuv's constants and libavif's float
# matrices, both ranges, and what cv2 refuses
DEPTH_NCLX = [(1, 6, 1), (1, 1, 0), (1, 1, 1), (9, 9, 0), (9, 12, 1),
              (1, 5, 0), (1, 2, 1), (1, 0, 1), (1, 0, 0), (1, 4, 0),
              (1, 7, 1), (1, 8, 1), (1, 8, 0), (4, 12, 0), (1, 15, 0),
              (1, 15, 1), (1, 3, 0), (1, 10, 1)]


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
def test_depth_matrices_and_ranges_as_cv2(tmp_path, depth, sub):
    """Every matrix and range at depth: libyuv's after Convert16To8Plane,
    libavif's float path over the depth's levels; what cv2 refuses is
    refused."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    stream = format_files.aom_encode(
        _planes_at(29, 43, sub, depth, seed=3), sub, bit_depth=depth,
        options={"cq-level": 25, "cpu-used": 5})
    for p, m, full in DEPTH_NCLX:
        path = _file(tmp_path, avif_bytes(
            stream, 43, 29, av1c_bytes(sub, depth), nclx=(p, 13, m, full),
            pixi=(depth,) * 3), f"m{p}_{m}_{full}.avif")
        if cv2.imread(path, cv2.IMREAD_COLOR) is None:
            _both_refuse(path)
        else:
            _same_as_cv2(path)


# ---------------------------------------------------------------------------
# alpha items and premultiplied alpha

def _alpha(kind: str, h: int, w: int, depth: int) -> np.ndarray:
    """An alpha plane: all opaque, all transparent, or partly
    transparent (a ramp with opaque, transparent and alpha-1 squares)."""
    top = (1 << depth) - 1
    if kind == "opaque":
        return np.full((h, w), top, np.uint16)
    if kind == "transparent":
        return np.zeros((h, w), np.uint16)
    y, x = np.mgrid[0:h, 0:w]
    a = ((x * 4 + y * 2) * (top + 1) // 256 % (top + 1)).astype(np.uint16)
    a[:8, :8], a[8:16, :8], a[:8, 8:16] = top, 0, 1 << (depth - 8)
    return a


def _alpha_file(colour, sub, depth, alpha, prem, nclx=(1, 13, 6, 1),
                size=None, alpha_depth=None) -> bytes:
    """A colour stream with an alpha item (``aom_encode``'s 4:0:0 stream
    of ``alpha``: limited range, as libaom writes it by default), a prem
    reference from the colour item to it where ``prem``; ``size`` the
    (height, width) both items' ispe give, by default the alpha's."""
    h, w = size or alpha.shape
    a_depth = alpha_depth or depth
    a_obus = format_files.aom_encode([alpha], "4:0:0", bit_depth=a_depth,
                                     options={"cq-level": 5, "cpu-used": 5})
    return avif_bytes(colour, w, h, av1c_bytes(sub, depth), nclx=nclx,
                      pixi=(depth,) * 3,
                      alpha=(a_obus, av1c_bytes("4:0:0", a_depth)),
                      iref_extra=((b"prem", 1, 2),) if prem else ())


# depth: (subsampling, the colr boxes: libyuv's constants, libavif's float
# path (fast at 4:4:4, slow where chroma is upsampled or for YCgCo))
PREM = {8: ("4:2:2", [(1, 6, 1), (1, 1, 0), (1, 15, 0), (1, 8, 1)]),
        10: ("4:2:0", [(1, 6, 1), (9, 9, 0), (1, 15, 0), (1, 8, 1)]),
        12: ("4:4:4", [(1, 6, 1), (1, 1, 0), (1, 15, 0), (1, 0, 1),
                       (1, 8, 1)])}


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("kind", ["opaque", "transparent", "partial"])
def test_prem_as_cv2(tmp_path, depth, kind):
    """Premultiplied alpha undone as libavif undoes it for cv2's BGRA:
    libyuv's ARGBUnattenuate after libyuv's conversion (alpha cut to 8
    bits by libyuv or libavif's float reformat) and after libavif's fast
    float path, in float in its slow path; limited-range alpha made full
    range first.  Opaque alpha leaves the colours as they are,
    transparent alpha makes them black."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    sub, colrs = PREM[depth]
    h, w = 27, 45
    planes = _planes_at(h, w, sub, max(depth, 10), seed=depth)
    if depth == 8:
        planes = [p >> 2 for p in planes]
    colour = format_files.aom_encode(planes, sub, bit_depth=depth, options={
        "cq-level": 25, "cpu-used": 5})
    alpha = _alpha(kind, h, w, depth)
    for nclx in colrs:
        nclx = (nclx[0], 13, nclx[1], nclx[2])
        plain, prem = (_same_as_cv2(_file(tmp_path, _alpha_file(
            colour, sub, depth, alpha, p, nclx), f"{p}.avif"))
            for p in (False, True))
        if kind == "transparent":
            assert not prem.any()
        elif kind == "partial":
            assert not np.array_equal(plain, prem)


@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
def test_alpha_item_at_depth_as_cv2(tmp_path, sub):
    """An alpha item, not premultiplied, still changes libavif's route
    above 8 bits (cv2 reads BGRA): libyuv's 10-bit YuvPixel10 with
    bilinear chroma at 10 bits, I012ToARGB's nearest chroma at 12-bit
    4:2:0; the colours differ from the same stream's without alpha."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    for depth in (10, 12):
        colour = format_files.aom_encode(
            _planes_at(30, 44, sub, depth, seed=1), sub, bit_depth=depth,
            options={"cq-level": 25, "cpu-used": 5})
        alone = _same_as_cv2(_file(tmp_path, avif_bytes(
            colour, 44, 30, av1c_bytes(sub, depth), pixi=(depth,) * 3),
            f"alone{depth}.avif"))
        with_alpha = _same_as_cv2(_file(tmp_path, _alpha_file(
            colour, sub, depth, _alpha("partial", 30, 44, depth), False),
            f"alpha{depth}.avif"))
        if depth == 10 or sub == "4:2:0":
            assert not np.array_equal(alone, with_alpha)


def test_alpha_item_ignored(tmp_path, stream):
    """An auxl alpha item at 8 bits, not premultiplied: cv2's IMREAD_COLOR
    pixels are the colour item's; premultiplied (prem from the colour
    item to it) they are un-premultiplied, as cv2's are (Pillow's alpha
    stream: full range)."""
    plain = _same_as_cv2(_file(tmp_path, _box(stream),
                               "plain.avif"))
    with_alpha = _file(tmp_path, _box(stream, alpha=stream))
    np.testing.assert_array_equal(_same_as_cv2(with_alpha), plain)
    prem = _file(tmp_path, _box(stream, alpha=stream,
                                      iref_extra=((b"prem", 1, 2),)),
                 "prem.avif")
    assert not np.array_equal(_same_as_cv2(prem), plain)


def test_prem_references_as_cv2(tmp_path, stream):
    """Only the colour item's last prem reference naming its alpha item
    marks the alpha premultiplied: one from the alpha item, or naming
    another item, does not; nor does a prem reference without alpha."""
    for i, refs in enumerate([((b"prem", 2, 1),), ((b"prem", 1, 1),),
                              ((b"prem", 1, 2), (b"prem", 1, 1)),
                              ((b"prem", 1, 1), (b"prem", 1, 2))]):
        _same_as_cv2(_file(tmp_path, _box(stream, alpha=stream,
                                          iref_extra=refs), f"r{i}.avif"))
    _same_as_cv2(_file(tmp_path, _box(stream, iref_extra=((b"prem", 1, 2),)),
                       "no_alpha.avif"))


def test_alpha_pairs_refused_as_cv2(tmp_path):
    """cv2 refuses alpha on a grey image and alpha of another bit depth;
    alpha of another size it reads (the colours are the alpha route's),
    and premultiplied the port refuses it by name (libavif scales the
    alpha to the image)."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    grey = format_files.aom_encode(_planes_at(24, 40, "4:0:0", 10), "4:0:0",
                                   bit_depth=10, options={"cq-level": 30})
    _both_refuse(_file(tmp_path, avif_bytes(
        grey, 40, 24, av1c_bytes("4:0:0", 10), pixi=(10,),
        alpha=(grey, av1c_bytes("4:0:0", 10))), "grey.avif"))
    colour = format_files.aom_encode(_planes_at(24, 40, "4:2:0", 10),
                                     "4:2:0", bit_depth=10,
                                     options={"cq-level": 30})
    for a_depth in (8, 12):
        _both_refuse(_file(tmp_path, _alpha_file(
            colour, "4:2:0", 10, _alpha("partial", 24, 40, a_depth), True,
            alpha_depth=a_depth), f"depth{a_depth}.avif"))
    taller = _alpha("partial", 32, 40, 10)
    _same_as_cv2(_file(tmp_path, _alpha_file(colour, "4:2:0", 10, taller,
                                             False, size=(24, 40)),
                       "taller.avif"))
    path = _file(tmp_path, _alpha_file(colour, "4:2:0", 10, taller, True,
                                       size=(24, 40)), "taller_prem.avif")
    assert load_image_rgb(path) is not None
    with pytest.raises(native.ImageError, match=f"^{path}: AVIF: "
                       "premultiplied alpha of another size"):
        native.decode_image(path)


# ---------------------------------------------------------------------------
# image sequences

def _sequence(mode="RGB", n=3) -> bytes:
    """Pillow's n-frame sequence (ftyp avis; meta with the first frame as
    its primary item; moov with one track, or two with alpha)."""
    frames = [Image.fromarray(_image(48, 64, seed=k)[..., :3]).convert(mode)
              for k in range(n)]
    if mode == "RGBA":
        for k, f in enumerate(frames):
            f.putalpha(Image.fromarray(
                (np.arange(64)[None] * 4 + 20 * k).repeat(48, 0)
                .clip(0, 255).astype(np.uint8)))
    out = io.BytesIO()
    frames[0].save(out, format="AVIF", save_all=True,
                   append_images=frames[1:], duration=100)
    return out.getvalue()


def _box_at(data, kind: bytes, start: int = 0) -> int:
    """Where the first ``kind`` box from ``start`` begins."""
    return data.index(kind, start) - 4


def _patch(data, kind: bytes, offset: int, value: bytes,
           start: int = 0) -> bytes:
    out = bytearray(data)
    at = _box_at(data, kind, start) + 8 + offset
    out[at:at + len(value)] = value
    return bytes(out)


def _samples(data):
    """Pillow's track's (offset, size) of each sample (one chunk)."""
    stco, stsz = _box_at(data, b"stco") + 16, _box_at(data, b"stsz") + 20
    offset = struct.unpack(">I", data[stco:stco + 4])[0]
    n = struct.unpack(">I", data[stsz - 4:stsz])[0]
    sizes = struct.unpack(f">{n}I", data[stsz:stsz + 4 * n])
    return [(offset + sum(sizes[:k]), sizes[k]) for k in range(n)]


def _meta_at_second(data) -> bytes:
    """The meta item pointed at the track's second sample."""
    (first, size), (second, size2) = _samples(data)[:2]
    at = data.index(struct.pack(">I", first), _box_at(data, b"iloc"))
    out = bytearray(data)
    out[at:at + 4] = struct.pack(">I", second)
    out[at + 4:at + 8] = struct.pack(">I", size2)
    assert out[at + 4:at + 8] != struct.pack(">I", size) or size == size2
    return bytes(out)


def _co64(data) -> bytes:
    """stco rewritten as co64 (8-byte offsets): the boxes around it 4
    bytes longer, mdat 4 bytes later."""
    at = _box_at(data, b"stco")
    n = struct.unpack(">I", data[at + 12:at + 16])[0]
    offsets = struct.unpack(f">{n}I", data[at + 16:at + 16 + 4 * n])
    body = data[at + 8:at + 16] + b"".join(struct.pack(">Q", o + 4 * n)
                                           for o in offsets)
    out = bytearray(data[:at] + struct.pack(">I", 8 + len(body)) + b"co64"
                    + body + data[at + 16 + 4 * n:])
    for kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
        k = _box_at(out, kind)
        size = struct.unpack(">I", out[k:k + 4])[0]
        out[k:k + 4] = struct.pack(">I", size + 4 * n)
    iloc = _box_at(out, b"iloc")
    first = struct.pack(">I", offsets[0])
    k = out.index(first, iloc)
    out[k:k + 4] = struct.pack(">I", offsets[0] + 4 * n)
    return bytes(out)


# name: (the file from Pillow's sequence, cv2 reads it)
SEQUENCES = {
    "rgb": (lambda d: d, True),
    "rgba_alpha_track": (lambda d: _sequence("RGBA"), True),
    "meta_item_at_second_sample": (_meta_at_second, True),
    "co64": (_co64, True),
    "two_frames": (lambda d: _sequence(n=2), True),
    "major_mif1": (lambda d: d.replace(b"avis", b"mif1", 1), True),
    "handler_vide": (lambda d: _patch(d, b"hdlr", 8, b"vide",
                                      _box_at(d, b"mdia")), True),
    "edit_list_media_time": (lambda d: _patch(d, b"elst", 16,
                                              struct.pack(">Q", 100)), True),
    "edit_list_not_repeating": (lambda d: _patch(d, b"elst", 0,
                                                 b"\1\0\0\0\0\0\0\2"),
                                True),
    "no_edit_list": (lambda d: d.replace(b"edts", b"free", 1), True),
    "no_sync_samples": (lambda d: d.replace(b"stss", b"free", 1), True),
    "edit_list_no_duration": (lambda d: _patch(d, b"elst", 8, bytes(8)),
                              False),
    "edit_list_two_entries": (lambda d: _patch(d, b"elst", 4,
                                               b"\0\0\0\2"), False),
    "edts_without_elst": (lambda d: d.replace(b"elst", b"free", 1), False),
    "chunk_without_samples": (lambda d: _patch(d, b"stsc", 12, bytes(4)),
                              False),
    "sample_table_short": (lambda d: _patch(d, b"stsc", 12,
                                            struct.pack(">I", 9)), False),
    "no_av01_entry": (lambda d: _patch(d, b"av01", -4, b"xxxx",
                                       _box_at(d, b"stsd")), False),
    "no_moov": (lambda d: d.replace(b"moov", b"free", 1), False),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_sequence_first_frame_as_cv2(tmp_path, case):
    """libavif reads the tracks of an avis major brand (or of a moov box
    under a major brand that is neither): the first sample of the first
    track with chunks and an av01 sample entry, whatever the meta item,
    the edit list or the sync samples say; an auxl track is its alpha.
    What libavif refuses in the sample table or the edit list, both
    refuse."""
    make, reads = SEQUENCES[case]
    data = make(_sequence())
    path = _file(tmp_path, data)
    if not reads:
        _both_refuse(path)
        return
    _same_as_cv2(path)
    if case == "meta_item_at_second_sample":
        (first, size), (second, size2) = _samples(data)[:2]
        assert _parts(data)[0] == data[second:second + size2] != \
            data[first:first + size]


def test_sequence_track_size_not_its_frame_refused(tmp_path):
    """A tkhd size that is not the first frame's: libavif scales the frame
    to it (as to an item's ispe), the port refuses, naming it."""
    data = _sequence()
    tkhd = _box_at(data, b"tkhd") + 8
    at = tkhd + 4 + (32 if data[tkhd] else 20) + 52
    bad = data[:at] + struct.pack(">II", 60 << 16, 48 << 16) + data[at + 8:]
    path = _file(tmp_path, bad)
    assert load_image_rgb(path).shape == (48, 60, 3)
    with pytest.raises(native.ImageError, match=f"^{path}: AVIF: the "
                       "track's 60x48 is not its first frame's 64x48"):
        native.decode_image(path)


# ---------------------------------------------------------------------------
# layered streams

def _with_operating_points(seq: bytes, points) -> bytes:
    """A full sequence header (no timing info) with its operating points
    replaced by ``points`` ((operating_point_idc, seq_level_idx), ...)."""
    bits = [(x >> (7 - i)) & 1 for x in seq for i in range(8)]
    assert bits[4] == 0 and bits[5] == 0      # not reduced, no timing info
    delay = bits[6]
    count = int("".join(map(str, bits[7:12])), 2) + 1
    pos = 12
    for _ in range(count):
        level = int("".join(map(str, bits[pos + 12:pos + 17])), 2)
        pos += 17 + (level > 7)
        if delay:
            pos += 5 if bits[pos] else 1
    end = len(bits) - 1 - bits[::-1].index(1)     # the trailing 1 bit
    put = lambda v, n: [(v >> (n - 1 - i)) & 1 for i in range(n)]
    out = bits[:6] + [0] + put(len(points) - 1, 5)
    for idc, level in points:
        out += put(idc, 12) + put(level, 5) + [0] * (level > 7)
    out += bits[pos:end] + [1]
    out += [0] * (-len(out) % 8)
    return bytes(int("".join(map(str, out[k:k + 8])), 2)
                 for k in range(0, len(out), 8))


def test_layered_stream_refused_by_name(tmp_path):
    """A sequence header with several operating points (layers): cv2 reads
    it (libavif asks libaom for operating point 0; the frame OBUs have
    no extension, so every point decodes them), the port refuses it,
    naming the tool; the same header rewritten with its one point of
    idc 0 reads as cv2."""
    obus = _obu_bodies(formats._avif_first_sample(
        _sequence(), _sequence_stbl(_sequence())))
    av1c = bytes([0x81, 0x0D, 0x0C, 0x00])
    one = _obu(1, _with_operating_points(obus[1], [(0, 13)])) + \
        _obu(6, obus[6])
    _same_as_cv2(_file(tmp_path, avif_bytes(one, 64, 48, av1c), "one.avif"))
    for i, points in enumerate([[(0x103, 13), (0x101, 13)], [(0x101, 13)],
                                [(0x301, 13), (0x101, 13)]]):
        stream = _obu(1, _with_operating_points(obus[1], points)) + \
            _obu(6, obus[6])
        path = _file(tmp_path, avif_bytes(stream, 64, 48, av1c),
                     f"layers{i}.avif")
        assert load_image_rgb(path) is not None
        with pytest.raises(native.ImageError, match=f"^{path}: AVIF: the AV1 "
                           "stream uses several operating points or layers"):
            native.decode_image(path)


def _sequence_stbl(data) -> dict:
    at = _box_at(data, b"moov")
    size = struct.unpack(">I", data[at:at + 4])[0]
    return formats._avif_tracks(data, at + 8, at + size)[0]["stbl"]


# ---------------------------------------------------------------------------
# the committed fixtures of this part

def test_committed_depth_fixtures():
    """``format_files.avif_depth_files`` is the recipe of the committed
    10/12-bit, sequence and prem AVIFs (``chip_smoke.py formats`` serves
    them): the same bytes again, each exercising what its name says."""
    if av1_tables.find_libaom() is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    files = format_files.avif_depth_files()
    assert sorted(files) == sorted(
        k for k in format_files.AVIF_KINDS if k.startswith(
            ("avif_10bit", "avif_12bit", "avif_sequence", "avif_prem")))
    for kind, data in files.items():
        assert format_files.COMMITTED[kind].read_bytes() == data, kind
    depth = {k: _info(files[k])["bit_depth"] for k in files
             if "bit" in k}
    assert depth == {"avif_10bit_420": 10, "avif_10bit_444_lr": 10,
                     "avif_10bit_film_grain": 10, "avif_12bit_422": 12,
                     "avif_10bit_400": 10, "avif_10bit_screen": 10}
    assert any(_types(_info(files["avif_10bit_444_lr"])))
    assert _info(files["avif_10bit_film_grain"])["apply_grain"] == 1
    counts = _counts(files["avif_10bit_screen"])
    assert counts["palette_y_blocks"] and counts["intrabc_blocks"]
    assert _info(files["avif_prem"])["bit_depth"] == 10
    assert b"prem" in files["avif_prem"]
    sequence = files["avif_sequence"]
    assert sequence[8:12] == b"avis" and _parts(sequence)[0] != \
        formats._avif_first_sample(sequence, _sequence_stbl(sequence))


# ---------------------------------------------------------------------------
# the tables

def test_tables_are_libaoms():
    lib = av1_tables.find_libaom()
    if lib is None:
        pytest.skip("no libaom.so.3 in the dynamic linker's cache")
    assert av1_tables.HEADER.read_text() == av1_tables.render(
        av1_tables.read_tables(lib))
