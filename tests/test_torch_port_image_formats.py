"""``native.decode_image`` -- the port's ``load_image_rgb`` -- against the
JAX package's ``load_image_rgb`` (``cv2.imread``) on PNG and BMP files, bit
for bit, and on the other formats cv2 reads (WebP and TIFF have files of
their own, ``test_torch_port_webp.py`` and ``test_torch_port_tiff.py``).

- PNG written by ``tools/format_files.py::png_bytes`` (which
  :func:`test_png_writer_is_read_by_cv2` holds to cv2 on the pixels it was
  given): every colour type at every bit
  depth, plain and Adam7, each row with a filter of its own (None, Sub, Up,
  Average, Paeth in turn); palettes with tRNS and an index past the
  palette's end; alpha dropped without compositing; 16-bit samples (the
  high byte); eXIf orientations 1..8 before and after the image data;
  bad CRCs in a critical and an ancillary chunk, an unknown critical chunk,
  a bad filter type, too little and too much image data, a cut file,
  trailing bytes; a PNG named ``.jpg``.
- BMP written by ``format_files.bmp_bytes``: BI_RGB at 1, 4, 8, 16, 24, 32 bits bottom-up and
  top-down, BI_BITFIELDS 5-5-5, 5-6-5 and 32-bit, RLE8 and RLE4 with runs,
  literals, end-of-line, delta and end-of-bitmap escapes, an RLE run past
  its row, the OS/2 header, odd widths (row padding).
- ``format_files.write_format_files``: every kind's decode equals cv2's
  and the SHA-256 recorded for ``chip_smoke.py formats``.
- WebP, TIFF, JPEG 2000, PNM, Sun raster, Radiance HDR and GIF files
  written by cv2 read as cv2 reads them (each has a file of tests of its
  own); an AVIF file raises naming the format; a file with no signature
  raises, and a GIF signature on a 0x0 screen raises naming GIF.
"""

import hashlib
import json
import struct
import zlib

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import formats, native
from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.tools import format_files
from objectdetectionpl_tpu_torch.tools.format_files import (bmp_bytes,
                                                           bmp_rows, chunk,
                                                           png_bytes)


def _assert_like_jax(path):
    """The port's load_image_rgb returns JAX's array bit for bit, or both
    refuse the file."""
    path = str(path)
    try:
        ref = load_image_rgb(path)
    except OSError:
        ref = None
    if ref is None:
        with pytest.raises(native.ImageError, match=f"^{path}: "):
            common.load_image_rgb(path)
        return None
    got = common.load_image_rgb(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape, path
    np.testing.assert_array_equal(got, ref, err_msg=path)
    return got


# ---------------------------------------------------------------------------
# PNG

def _exif(orientation: int, little: bool = True) -> bytes:
    e = "<" if little else ">"
    tiff = ((b"II*\x00" if little else b"MM\x00*") + struct.pack(e + "I", 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x112, 3, 1, orientation, 0)
            + bytes(4))
    return chunk(b"eXIf", tiff)


NCH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
CASES = [(c, d, i) for c in DEPTHS for d in DEPTHS[c] for i in (0, 1)]


def _samples(rng, h, w, color, depth):
    top = (1 << depth) - 1
    return rng.randint(0, top + 1, (h, w, NCH[color]))


@pytest.mark.parametrize("color,depth,interlace", CASES)
def test_png_every_type_depth_and_adam7(tmp_path, color, depth, interlace):
    rng = np.random.RandomState(color * 100 + depth * 2 + interlace)
    for h, w in ((13, 11), (1, 1), (8, 33)):
        s = _samples(rng, h, w, color, depth)
        palette = trns = None
        if color == 3:
            n = min(1 << depth, 200)
            palette = rng.randint(0, 256, 3 * n).astype(np.uint8)
            trns = bytes(rng.randint(0, 256, n // 2).astype(np.uint8))
        elif color in (0, 2) and depth == 8:
            trns = bytes(2 * NCH[color])
        path = tmp_path / f"p{h}x{w}.png"
        path.write_bytes(png_bytes(s, color, depth, interlace, palette, trns))
        got = _assert_like_jax(path)
        assert got is not None and got.shape == (h, w, 3)


def test_png_writer_is_read_by_cv2(tmp_path):
    """The writer above is right: cv2 returns the RGB samples it was
    given."""
    rng = np.random.RandomState(0)
    s = rng.randint(0, 256, (9, 14, 3))
    for interlace in (0, 1):
        path = tmp_path / f"w{interlace}.png"
        path.write_bytes(png_bytes(s, 2, 8, interlace))
        np.testing.assert_array_equal(cv2.imread(str(path))[..., ::-1], s)


def test_png_samples_are_cv2s(tmp_path):
    """16 bits keep the high byte, 2-bit grey scales by 85, alpha and tRNS
    are dropped, a palette index past the palette is black."""
    cases = {
        "g16": (png_bytes(np.array([[[1000], [0x80FF], [0xFFFF]]]), 0, 16),
                [[3] * 3, [128] * 3, [255] * 3]),
        "g2": (png_bytes(np.array([[[0], [1], [2], [3]]]), 0, 2),
               [[0] * 3, [85] * 3, [170] * 3, [255] * 3]),
        "rgba": (png_bytes(np.array([[[200, 100, 50, 0], [1, 2, 3, 128]]]), 6, 8),
                 [[200, 100, 50], [1, 2, 3]]),
        "pal": (png_bytes(np.array([[[0], [5]]]), 3, 8, palette=[10, 20, 30],
                     trns=b"\x00"), [[10, 20, 30], [0, 0, 0]]),
    }
    for name, (data, want) in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        got = _assert_like_jax(path)
        np.testing.assert_array_equal(got[0], want, err_msg=name)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation(tmp_path, orientation):
    rng = np.random.RandomState(orientation)
    s = rng.randint(0, 256, (6, 10, 3))
    for where in ("before", "after"):
        for little in (True, False):
            ex = _exif(orientation, little)
            path = tmp_path / f"o_{where}_{little}.png"
            path.write_bytes(png_bytes(s, 2, 8, **{where: ex}))
            got = _assert_like_jax(path)
            assert got.shape == ((10, 6, 3) if orientation >= 5 else
                                 (6, 10, 3))
            assert np.array_equal(
                native.decode_image(str(path), exif=False), s)


def _bad_crc(data: bytes, ctype: bytes) -> bytes:
    i = data.index(ctype)
    n = struct.unpack(">I", data[i - 4:i])[0]
    out = bytearray(data)
    out[i + 4 + n] ^= 1
    return bytes(out)


def test_png_damaged_files(tmp_path):
    """Each kind of damage is read, or refused, as cv2 reads it."""
    rng = np.random.RandomState(3)
    s = rng.randint(0, 256, (5, 7, 3))
    good = png_bytes(s, 2, 8)
    text = chunk(b"tEXt", b"k\x00v")
    files = {
        "idat_crc": (_bad_crc(good, b"IDAT"), False),
        "ihdr_crc": (_bad_crc(good, b"IHDR"), False),
        "text_crc": (_bad_crc(png_bytes(s, 2, 8, before=text), b"tEXt"), True),
        "exif_crc": (_bad_crc(png_bytes(s, 2, 8, before=_exif(6)), b"eXIf"),
                     True),
        "critical": (png_bytes(s, 2, 8, before=chunk(b"ABCD", b"xy")), False),
        "ancillary": (png_bytes(s, 2, 8, before=chunk(b"abCD", b"xy")), True),
        "filter": (png_bytes(s[:1, :2], 2, 8, idat=b"\x07" + bytes(6)), False),
        "short": (png_bytes(s, 2, 8, idat=bytes(10)), False),
        "long": (png_bytes(s[:1, :2], 2, 8, idat=bytes(7) + bytes(9)), True),
        "cut": (good[:len(good) - 20], False),
        "no_iend": (good[:-12], False),
        "trailing": (good + b"junk", True),
    }
    for name, (data, readable) in files.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        got = _assert_like_jax(path)
        assert (got is not None) == readable, name


def test_png_named_jpg_is_read_aspng_bytes(tmp_path):
    rng = np.random.RandomState(4)
    s = rng.randint(0, 256, (12, 9, 3))
    path = tmp_path / "photo.jpg"
    path.write_bytes(png_bytes(s, 2, 8))
    np.testing.assert_array_equal(_assert_like_jax(path), s)


# ---------------------------------------------------------------------------
# BMP

@pytest.mark.parametrize("bpp", [1, 4, 8])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_palette(tmp_path, bpp, top_down):
    rng = np.random.RandomState(bpp + 10 * top_down)
    for w, h, clrused in ((13, 5, 0), (3, 2, (1 << bpp) // 2 or 1)):
        n = clrused or 1 << bpp
        palette = bytes(rng.randint(0, 256, 4 * n).astype(np.uint8))
        idx = rng.randint(0, 1 << bpp, (h, w))
        path = tmp_path / f"p{w}.bmp"
        path.write_bytes(bmp_bytes(w, h, bpp, bmp_rows(idx, bpp), palette=palette,
                              clrused=clrused, top_down=top_down))
        assert _assert_like_jax(path) is not None


@pytest.mark.parametrize("bpp,compression,masks", [
    (16, 0, ()), (24, 0, ()), (32, 0, ()),
    (16, 3, (0x7C00, 0x3E0, 0x1F)), (16, 3, (0xF800, 0x7E0, 0x1F)),
    (32, 3, (0xFF0000, 0xFF00, 0xFF)), (32, 3, (0xFF, 0xFF00, 0xFF0000)),
    (16, 3, (0xF00, 0xF0, 0xF))])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_direct_colour(tmp_path, bpp, compression, masks, top_down):
    rng = np.random.RandomState(bpp + compression + len(masks))
    w, h = 7, 4
    if bpp == 16:
        rows = rng.randint(0, 1 << 16, (h, w))
    else:
        rows = rng.randint(0, 256, (h, w * bpp // 8))
    path = tmp_path / "d.bmp"
    path.write_bytes(bmp_bytes(w, h, bpp, bmp_rows(rows, 16 if bpp == 16 else 8),
                          compression,
                          masks=b"".join(struct.pack("<I", m) for m in masks),
                          top_down=top_down))
    got = _assert_like_jax(path)
    assert (got is None) == (masks == (0xF00, 0xF0, 0xF))


def test_bmp_os2_header(tmp_path):
    rng = np.random.RandomState(7)
    for bpp in (8, 24):
        w, h = 5, 3
        palette = bytes(rng.randint(0, 256, 3 * 256).astype(np.uint8)) \
            if bpp == 8 else b""
        rows = rng.randint(0, 256, (h, w if bpp == 8 else 3 * w))
        path = tmp_path / f"os2_{bpp}.bmp"
        path.write_bytes(bmp_bytes(w, h, bpp, bmp_rows(rows, 8), palette=palette,
                              os2=True))
        assert _assert_like_jax(path) is not None


RLE8 = {
    "runs": (4, 3, bytes([4, 1, 2, 0, 2, 5, 0, 0, 3, 2, 1, 6, 0, 1])),
    "literal": (5, 2, bytes([0, 3, 1, 2, 3, 0, 2, 4, 0, 0, 0, 5, 5, 6, 7, 8,
                             9, 0, 0, 1])),
    "delta": (6, 4, bytes([2, 1, 0, 2, 2, 1, 2, 3, 0, 1])),
    "eob_early": (5, 4, bytes([3, 2, 0, 1])),
    "row_overrun": (4, 2, bytes([6, 1, 0, 1])),
    "no_eob": (4, 2, bytes([4, 1])),
    "exact_rows": (3, 2, bytes([3, 1, 3, 2])),
}
RLE4 = {
    "runs": (5, 3, bytes([5, 0x12, 0, 0, 3, 0x34, 0, 0, 4, 0x56, 0, 1])),
    "literal": (6, 2, bytes([0, 5, 0x12, 0x34, 0x50, 0, 0, 0, 0, 6, 0x78,
                             0x9A, 0xBC, 0, 0, 1])),
    "delta": (7, 4, bytes([2, 0x11, 0, 2, 2, 1, 3, 0x21, 0, 1])),
    "row_overrun": (3, 2, bytes([5, 0x12, 0, 1])),
    "eob_last_row": (5, 3, bytes([5, 0x11, 0, 0, 5, 0x22, 0, 0, 2, 0x33, 0,
                                  1])),
    "eob_first_row": (5, 3, bytes([5, 0x11, 0, 0, 0, 1])),
    "delta_down": (5, 3, bytes([0, 2, 2, 1, 1, 0x33, 0, 0, 0, 0])),
    "delta_across": (5, 3, bytes([0, 2, 2, 0, 1, 0x33, 0, 0, 0, 0, 0, 0])),
}
# cv2 refuses these: a run past its row, data that end before the bitmap
# (cv2's RLE4 escapes move down no row, so its streams need an end-of-line
# for every row)
RLE_REFUSED = {False: ("row_overrun", "no_eob"),
               True: ("row_overrun", "delta", "eob_first_row", "delta_down")}


@pytest.mark.parametrize("four,name", [(False, n) for n in RLE8]
                         + [(True, n) for n in RLE4])
def test_bmp_rle(tmp_path, four, name):
    w, h, stream = (RLE4 if four else RLE8)[name]
    rng = np.random.RandomState(len(name))
    n = 16 if four else 256
    palette = bytes(rng.randint(1, 256, 4 * n).astype(np.uint8))
    path = tmp_path / f"{name}.bmp"
    path.write_bytes(bmp_bytes(w, h, 4 if four else 8, stream, 2 if four else 1,
                          palette=palette))
    got = _assert_like_jax(path)
    assert (got is None) == (name in RLE_REFUSED[four])


# ---------------------------------------------------------------------------
# the other formats cv2 reads

@pytest.mark.parametrize("ext,name", [(".webp", "WebP"), (".tiff", "TIFF"),
                                      (".jp2", "JPEG 2000"), (".ppm", "PNM"),
                                      (".ras", "Sun raster"),
                                      (".hdr", "Radiance HDR"),
                                      (".gif", "GIF"), (".avif", "AVIF")])
def test_other_formats_raise_naming_the_format(tmp_path, ext, name):
    """cv2.imwrite's file of each other format, under its name and a .jpg
    one, equals cv2's decode: WebP, TIFF, JPEG 2000, PNM, Sun raster,
    Radiance HDR, GIF and AVIF (cv2's default AVIF: CDEF, quantizer
    matrices, delta q)."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    path = tmp_path / f"img{ext}"
    assert cv2.imwrite(str(path), img)
    assert load_image_rgb(str(path)).shape == (64, 64, 3)   # cv2 reads it
    named = tmp_path / "img.jpg"                             # any name
    named.write_bytes(path.read_bytes())
    for p in (path, named):
        assert formats.sniff(p.read_bytes()[:formats.AVIF_HEAD]) == name
        assert _assert_like_jax(p) is not None


def test_no_signature_raises(tmp_path):
    path = tmp_path / "x.jpg"
    path.write_bytes(b"GIF90a" + bytes(40))
    with pytest.raises(OSError, match="no JPEG, PNG, BMP, GIF, WebP, TIFF, "
                                      "JPEG 2000, AVIF, PNM, PAM, PFM, Sun "
                                      "raster or Radiance HDR signature"):
        common.load_image_rgb(str(path))
    with pytest.raises(OSError, match="cannot read the file"):
        common.load_image_rgb(str(tmp_path / "missing.png"))


def test_gif_signature_and_zeros_raise_naming_gif(tmp_path):
    """``GIF89a`` and 40 zero bytes: a GIF signature on a 0x0 screen, which
    cv2 returns None for, raises naming GIF (under any name)."""
    for name in ("x.gif", "x.jpg"):
        path = tmp_path / name
        path.write_bytes(b"GIF89a" + bytes(40))
        assert cv2.imread(str(path)) is None
        with pytest.raises(native.ImageError, match=f"^{path}: GIF: "):
            common.load_image_rgb(str(path))


def _jpeg_2000(img, raw: bool, w: int, h: int) -> bytes:
    """cv2's JP2 write of ``img`` with SIZ (and ihdr) saying w x h, one
    tile; ``raw``: the bare codestream."""
    data = cv2.imencode(".jp2", img)[1].tobytes()
    at = data.index(b"\xff\x4f\xff\x51")
    siz = struct.pack(">IIIIII", w, h, 0, 0, w, h)
    data = data[:at + 8] + siz + data[at + 32:]
    if raw:
        return data[at:]
    at = data.index(b"ihdr") + 4
    return data[:at] + struct.pack(">II", h, w) + data[at + 8:]


def _tiff_size(data: bytes, w: int, h: int) -> bytes:
    """A little-endian classic TIFF with ImageWidth and ImageLength set."""
    out = bytearray(data)
    ifd = struct.unpack("<I", data[4:8])[0]
    for k in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * k
        tag, typ = struct.unpack("<HH", data[at:at + 4])
        if tag in (256, 257):
            v = w if tag == 256 else h
            out[at + 8:at + 12] = struct.pack("<HH", v, 0) if typ == 3 \
                else struct.pack("<I", v)
    return bytes(out)


def _webp_canvas(img, w: int, h: int) -> bytes:
    """cv2's WebP of ``img`` behind a VP8X chunk whose canvas is w x h."""
    vp8 = cv2.imencode(".webp", img)[1].tobytes()[12:]
    vp8x = b"VP8X" + struct.pack("<II", 10, 0) + \
        struct.pack("<I", w - 1)[:3] + struct.pack("<I", h - 1)[:3]
    return b"RIFF" + struct.pack("<I", 4 + len(vp8x) + len(vp8)) + \
        b"WEBP" + vp8x + vp8


def _oversized(kind: str, w: int, h: int) -> bytes:
    """A small file of ``kind`` whose header says w x h."""
    img = np.random.RandomState(5).randint(0, 256, (64, 64, 3)).astype(
        np.uint8)
    if kind == "JPEG":
        data = cv2.imencode(".jpg", img)[1].tobytes()
        at = data.index(b"\xff\xc0") + 5
        return data[:at] + struct.pack(">HH", h, w) + data[at + 4:]
    if kind == "PNG":
        data = png_bytes(img, 2, 8)
        body = b"IHDR" + struct.pack(">II", w, h) + data[24:29]
        return data[:12] + body + struct.pack(">I", zlib.crc32(body)) + \
            data[33:]
    if kind == "BMP":
        data = cv2.imencode(".bmp", img)[1].tobytes()
        return data[:18] + struct.pack("<ii", w, h) + data[26:]
    if kind == "TIFF":
        return _tiff_size(format_files.tiff_bytes(img), w, h)
    if kind == "WebP":
        return _webp_canvas(img, w, h)
    if kind == "GIF":
        data = cv2.imencode(".gif", img)[1].tobytes()
        return data[:6] + struct.pack("<HH", w, h) + data[10:]
    if kind == "JPEG 2000 codestream":
        return _jpeg_2000(img, True, w, h)
    if kind == "JPEG 2000":
        return _jpeg_2000(img, False, w, h)
    if kind == "PNM":
        return b"P5\n%d %d\n255\n" % (w, h) + bytes(min(w * h, 1 << 21))
    if kind == "PAM":
        return (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\n"
                b"TUPLTYPE RGB\nENDHDR\n" % (w, h)) + bytes(192)
    if kind == "PFM":
        return b"PF\n%d %d\n-1.0\n" % (w, h) + bytes(64 * 64 * 12)
    if kind == "Sun raster":
        data = cv2.imencode(".ras", img)[1].tobytes()
        return data[:4] + struct.pack(">ii", w, h) + data[12:]
    assert kind == "Radiance HDR"
    return b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w) \
        + bytes(256)


@pytest.mark.parametrize("kind,w,h", [
    ("JPEG", 40000, 40000), ("PNG", 40000, 40000), ("BMP", 40000, 40000),
    ("BMP", 40000, -40000), ("TIFF", 65535, 65535),
    ("WebP", 1 << 20, 1 << 11), ("GIF", 65535, 65535),
    ("JPEG 2000 codestream", 40000, 40000), ("JPEG 2000", 40000, 40000),
    ("PNM", (1 << 20) + 1, 1), ("PNM", 40000, 40000), ("PAM", 40000, 40000),
    ("PFM", 40000, 40000), ("Sun raster", 40000, 40000),
    ("Radiance HDR", 40000, 40000)])
def test_sizes_past_cv2s_limits_raise(tmp_path, kind, w, h):
    """A header past cv2.imread's limits (more than 2^20 columns or rows,
    or 2^30 pixels), which cv2 5.0 refuses with an assertion (cv2.error;
    JAX's load_image_rgb lets it through), raises ImageError before the
    port makes anything of that size."""
    path = tmp_path / "big.jpg"
    path.write_bytes(_oversized(kind, w, h))
    with pytest.raises(cv2.error, match="validateInputImageSize"):
        cv2.imread(str(path))
    with pytest.raises(native.ImageError,
                       match=f"a {w}x{abs(h)} image, larger than cv2 reads"):
        common.load_image_rgb(str(path))


def test_size_at_cv2s_limit_reads(tmp_path):
    """2^20 columns is inside the limit: a grey PNM of one such row reads
    as cv2 reads it."""
    path = tmp_path / "wide.pgm"
    path.write_bytes(b"P5\n%d 1\n255\n" % (1 << 20)
                     + bytes(range(256)) * (1 << 12))
    assert _assert_like_jax(path).shape == (1, 1 << 20, 3)


def test_sniff():
    assert formats.sniff(b"\xff\xd8\xff\xe0") == "JPEG"
    assert formats.sniff(b"\xff\xd8\x00") == ""
    assert formats.sniff(formats.PNG_SIGNATURE) == "PNG"
    assert formats.sniff(b"BM\x00") == "BMP"
    assert formats.sniff(b"\x00\x00\x00\x1cftypavif") == "AVIF"
    # libavif's rule: avif or avis, major or compatible brand
    ftyp = b"\x00\x00\x00\x18ftypmif1\x00\x00\x00\x00mif1"
    assert formats.sniff(ftyp + b"avif") == "AVIF"
    assert formats.sniff(ftyp + b"avis") == "AVIF"
    assert formats.sniff(ftyp + b"miaf") == ""
    assert formats.sniff(b"\x00\x00\x00\x10ftypmif1\x00\x00\x00\x00") == ""
    assert formats.sniff(b"\x59\xa6\x6a\x95") == "Sun raster"
    assert formats.sniff(b"#?RADIANCE\n") == "Radiance HDR"
    assert formats.sniff(b"\x76\x2f\x31\x01") == "OpenEXR"
    assert formats.sniff(b"GIF87a") == formats.sniff(b"GIF89a") == "GIF"
    assert formats.sniff(b"GIF88a") == ""
    assert formats.sniff(b"\xff\x4f\xff\x51\x00") == "JPEG 2000"
    assert formats.sniff(formats.JP2_SIGNATURE) == "JPEG 2000"
    assert formats.sniff(b"P6\n") == "PNM"
    assert formats.sniff(b"P7\n") == "PAM"
    assert formats.sniff(b"PF\n") == formats.sniff(b"Pf\n") == "PFM"


def test_format_files_equal_their_hashes(tmp_path):
    """The files ``chip_smoke.py formats`` serves: the port decodes each as
    cv2 does, and cv2's decodes are the recorded hashes the card machine
    (which has no cv2) checks against."""
    want = json.loads(format_files.HASHES.read_text())
    paths = format_files.write_format_files(tmp_path)
    assert sorted(paths) == sorted(want) == sorted(format_files.KINDS)
    for kind, path in paths.items():
        got = _assert_like_jax(path)
        assert list(got.shape) == want[kind]["shape"], kind
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            want[kind]["sha256"], kind
