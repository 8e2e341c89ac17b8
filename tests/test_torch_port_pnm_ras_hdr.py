"""PNM, PAM, PFM, Sun raster and Radiance HDR files through the port's
readers (``data/formats.py``: ``read_pnm``, ``read_pam``, ``read_pfm``,
``read_sun``, ``read_hdr``) against the JAX package's ``load_image_rgb``
(``cv2.imread``: cv2's PxMDecoder, PAMDecoder, PFMDecoder,
SunRasterDecoder and HdrDecoder), bit for bit, under the format's own
extension and a .jpg one.

- PNM: ``cv2.imwrite`` (ASCII and binary .pbm, .pgm, .ppm, .pnm); P1-P6
  written here at maxval 1..65535, samples above maxval, comments and
  whitespace in the header and between ASCII samples, P1 digits with and
  without separators, CR line ends; refused: maxval 0 or above 65535, a
  zero width, bad bytes in a number, files cut short;
- PAM: ``cv2.imwrite``; DEPTH 1-4 x MAXVAL 1..65535 x every TUPLTYPE and
  none (cv2 requires the TUPLTYPE's depth, reads MAXVAL 1 as packed bits,
  copies RGB into its BGR image as it stands), numbers with whitespace
  around them, comments and blank lines, repeated and unknown fields;
  GRAYSCALE_ALPHA and RGB_ALPHA on the pixels cv2 defines (it leaves the
  rest of each row uninitialised);
- PFM: little- and big-endian by the scale's sign, scales decimal,
  exponent, hexadecimal and infinite, rounding at halves, NaN and values
  past int32; refused: a grey PFM, a scale of 0 or NaN, files cut short;
- Sun raster: RT_OLD and RT_STANDARD at 1, 8, 24 and 32 bits, colour
  maps of 1 to 256 entries and none, odd widths (rows padded to 16
  bits); refused: RT_BYTE_ENCODED and RT_FORMAT_RGB (cv2's header check
  refuses them), other depths and map types, maps too long, files cut
  short;
- Radiance HDR: ``cv2.imwrite``; new-style RLE and flat scanlines,
  widths below 8 (always flat), an RLE image that turns flat, exponents
  0..255, #?RADIANCE and #?RGBE, header lines around FORMAT; refused:
  XYZE, the other orientations, blank or NUL header lines, bad scanlines,
  files cut short.
"""

import struct

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.tools.format_files import (
    RT_BYTE_ENCODED, RT_FORMAT_RGB, RT_OLD, RT_STANDARD, hdr_bytes,
    hdr_rle_scanline, sun_bytes)


def like_cv2(tmp_path, data: bytes, ext: str, kind: str, columns=None):
    """The port reads ``data`` as cv2 does under ``ext`` and .jpg names
    (on the first ``columns`` columns only when given); returns cv2's
    image, or None when both refuse it, the port naming ``kind``."""
    out = None
    for suffix in (ext, ".jpg"):
        path = tmp_path / f"img{suffix}"
        path.write_bytes(data)
        if cv2.imread(str(path)) is None:
            for fn in (native.decode_image, common.load_image_rgb):
                with pytest.raises(native.ImageError,
                                   match=f"^{path}: {kind}: "):
                    fn(str(path))
            continue
        ref = load_image_rgb(str(path))
        for fn in (native.decode_image, common.load_image_rgb):
            got = fn(str(path))
            assert got.dtype == np.uint8 and got.shape == ref.shape
            np.testing.assert_array_equal(got[:, :columns],
                                          ref[:, :columns], err_msg=str(path))
        out = ref
    return out


# ---------------------------------------------------------------------------
# PNM

def test_pnm_cv2_imwrite(tmp_path):
    """Each extension's writes that cv2 makes (.ppm takes colour, .pgm
    grey, .pbm bits, .pnm either)."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (9, 13, 3)).astype(np.uint8)
    written = 0
    for ext in (".ppm", ".pgm", ".pbm", ".pnm"):
        for arr in (img, img[..., 0], (img[..., 0] > 128).astype(np.uint8)
                    * 255, img.astype(np.uint16) * 257,
                    img[..., 0].astype(np.uint16) * 257):
            for binary in (0, 1):
                path = tmp_path / f"w{ext}"
                path.unlink(missing_ok=True)
                try:
                    cv2.imwrite(str(path), arr,
                                [cv2.IMWRITE_PXM_BINARY, binary])
                except cv2.error:
                    pass
                if not path.exists():
                    continue
                written += 1
                assert like_cv2(tmp_path, path.read_bytes(), ext,
                                "PNM") is not None
    assert written >= 20


def _pnm(kind, w, h, body: bytes, maxval=None) -> bytes:
    head = f"P{kind}\n{w} {h}\n" + (f"{maxval}\n" if maxval else "")
    return head.encode() + body


@pytest.mark.parametrize("maxval", [1, 2, 100, 255, 256, 1000, 65535])
def test_pnm_maxvals(tmp_path, maxval):
    """ASCII samples clamp to maxval and scale; binary 8-bit ones are
    taken as they are, 16-bit ones by their high byte."""
    rng = np.random.RandomState(maxval)
    h, w = 5, 7
    for top in (maxval + 1, min(65536, 2 * maxval + 2)):  # some past maxval
        v = rng.randint(0, top, (h, w, 3))
        for kind, arr in ((3, v), (2, v[..., 0])):
            text = (" ".join(map(str, arr.reshape(-1))) + "\n").encode()
            assert like_cv2(tmp_path, _pnm(kind, w, h, text, maxval), ".ppm",
                            "PNM") is not None
        wide = ">u2" if maxval > 255 else np.uint8
        for kind, arr in ((6, v), (5, v[..., 0])):
            raw = np.minimum(arr, 65535 if maxval > 255 else 255)
            assert like_cv2(tmp_path, _pnm(kind, w, h,
                                           raw.astype(wide).tobytes(),
                                           maxval), ".ppm", "PNM") is not None


def test_pnm_bits_and_syntax(tmp_path):
    rng = np.random.RandomState(1)
    h, w = 5, 11
    bits = rng.randint(0, 2, (h, w))
    v = rng.randint(0, 256, (h, w, 3))
    text = " ".join(map(str, v.reshape(-1)))
    for data in (_pnm(1, w, h, " ".join(map(str, bits.reshape(-1))).encode()),
                 _pnm(1, w, h, "".join(map(str, bits.reshape(-1))).encode()),
                 _pnm(1, w, h, "\n".join("".join(map(str, r)) for r in
                                         (bits * 7)).encode()),
                 _pnm(4, w, h, np.packbits(bits.astype(np.uint8),
                                           axis=1).tobytes()),
                 b"P6 # a comment\n#another\n 11\t5 # x\n255\n"
                 + v.astype(np.uint8).tobytes(),
                 b"P6\n11 5\n255 " + v.astype(np.uint8).tobytes(),
                 b"P6\n11 5\n255\r\n" + v.astype(np.uint8).tobytes()[:-1],
                 _pnm(6, w, h, v.astype(np.uint8).tobytes() + b"more", 255),
                 _pnm(3, w, h, (text.replace(" 1", " #c\n1", 3)
                                .replace(" 2", " #c\r2", 3) + "\n").encode(),
                      255),
                 _pnm(3, w, h, (text + " x").encode(), 255)):
        assert like_cv2(tmp_path, data, ".ppm", "PNM") is not None
    for data in (_pnm(6, w, h, v.astype(np.uint8).tobytes()[:-1], 255),
                 _pnm(3, w, h, text.encode(), 255),      # ends in a number
                 _pnm(3, w, h, b"", 0), _pnm(3, w, h, b"", 70000),
                 b"P6\n0 5\n255\n", b"P6\n11 5 x\n", b"P5\n11 5\n25",
                 _pnm(3, w, h, (text[:len(text) // 2] + "\n").encode(),
                      255)):
        assert like_cv2(tmp_path, data, ".ppm", "PNM") is None


# ---------------------------------------------------------------------------
# PAM

_TUPLTYPES = [None, "BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB",
              "RGB_ALPHA", "FOO"]


def _pam(w, h, depth, maxval, tupltype, body, lines="") -> bytes:
    head = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
            + (f"TUPLTYPE {tupltype}\n" if tupltype else "") + lines
            + "ENDHDR\n")
    return head.encode() + body


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_pam_depths_maxvals_tupltypes(tmp_path, depth):
    rng = np.random.RandomState(depth)
    h, w = 5, 9
    for maxval in (1, 100, 255, 1000, 65535):
        for tupltype in _TUPLTYPES:
            v = rng.randint(0, 256 if maxval == 1 else maxval + 1,
                            (h, w, depth))
            body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
            alpha = (depth, tupltype) in ((2, "GRAYSCALE_ALPHA"),
                                          (4, "RGB_ALPHA"))
            like_cv2(tmp_path, _pam(w, h, depth, maxval, tupltype, body),
                     ".pam", "PAM", columns=-(-w // depth) if alpha else None)


def test_pam_cv2_imwrite_and_header(tmp_path):
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (6, 9, 3)).astype(np.uint8)
    # cv2 writes no TUPLTYPE, so it cannot read its own 16-bit PAMs
    for arr, reads in ((img, True), (img[..., 0], True),
                       (img[..., 0].astype(np.uint16) * 257, False),
                       (img.astype(np.uint16) * 257, False)):
        path = tmp_path / "w.pam"
        assert cv2.imwrite(str(path), arr)
        assert (like_cv2(tmp_path, path.read_bytes(), ".pam", "PAM")
                is not None) == reads
    body = img.tobytes()
    head = "WIDTH {}\nHEIGHT 6\nDEPTH 3\nMAXVAL 255\n"
    for width, reads in (("9", True), ("9 ", True), ("\t9", True),
                         ("09", True), ("9\t", True), ("9 x", False),
                         ("9x", False), ("9 9", False), ("0x9", False),
                         ("+9", False), ("", False)):
        data = ("P7\n" + head.format(width) + "ENDHDR\n").encode() + body
        assert (like_cv2(tmp_path, data, ".pam", "PAM") is not None) == reads
    for data, reads in (
            (b"P7\n#comment\nWIDTH 9\n\nHEIGHT 6\nDEPTH 3\nMAXVAL 255\n"
             b"ENDHDR\n" + body, True),
            (b"P7\nWIDTH  9\nHEIGHT 6\nDEPTH 3\nMAXVAL 255\nENDHDR\r\n"
             + body, True),
            (b"P7\nWIDTH 9\nHEIGHT 6\nDEPTH 3\nMAXVAL 255\nENDHDR 5\n"
             + body, True),
            (_pam(9, 6, 3, 255, "RGB ", body), True),
            (_pam(9, 6, 3, 255, " RGB", body), True),
            (_pam(9, 6, 3, 255, "RGB", body, "TUPLTYPE GRAYSCALE\n"), False),
            (_pam(9, 6, 3, 255, None, body, "WIDTH 9\n"), False),
            (_pam(9, 6, 3, 255, None, body, "XYZ 1\n"), False),
            (b"P7\nWIDTH 9\nHEIGHT 6\nDEPTH 3\nENDHDR\n" + body, False),
            (b"P7 \nWIDTH 9\nHEIGHT 6\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
             + body, False),
            (_pam(9, 6, 3, 255, None, body[:-1]), False),
            (_pam(9, 6, 3, 65536, None, body), False),
            (_pam(9, 6, 5, 255, None, body + body), False)):
        assert (like_cv2(tmp_path, data, ".pam", "PAM") is not None) == reads


# ---------------------------------------------------------------------------
# PFM

def _pfm(arr, scale="-1.0", big=None, head=None) -> bytes:
    h, w = arr.shape[:2]
    if big is None:
        big = not scale.lstrip().startswith("-")
    if head is None:
        head = f"PF\n{w} {h}\n{scale}\n".encode()
    return head + arr[::-1].astype(">f4" if big else "<f4").tobytes()


def test_pfm(tmp_path):
    rng = np.random.RandomState(6)
    a = rng.uniform(-20, 300, (6, 7, 3)).astype(np.float32)
    halves = (np.arange(6 * 7 * 3).reshape(6, 7, 3) % 256 + 0.5).astype(
        np.float32)
    for scale in ("-1.0", "1.0", "-2.5", "0.5", "-0.001", "3", "-1e2",
                  "1.5e-1", "0x10", "-0x1.8p1", "-inf", "inf", "-Infinity",
                  "+2", "1e", "-.5"):
        for arr in (a, halves):
            assert like_cv2(tmp_path, _pfm(arr, scale), ".pfm", "PFM") \
                is not None
    for value in (np.inf, -np.inf, np.nan, 3e9, -3e9, 2.1e9, 1e30):
        assert like_cv2(tmp_path, _pfm(np.full((6, 7, 3), value,
                                               np.float32)),
                        ".pfm", "PFM") is not None
    for data in (_pfm(a, head=b"PF\n7\n6\n-1\n"),
                 _pfm(a, head=b"PF\n7x 6\n-1.0x\n"), _pfm(a) + b"more"):
        assert like_cv2(tmp_path, data, ".pfm", "PFM") is not None
    for data in (_pfm(a, "nan"), _pfm(a, "-0"), _pfm(a, "0x"),
                 _pfm(a)[:-1], _pfm(a, head=b"PF\r\n7 6\n-1\n"),
                 b"Pf\n7 6\n-1.0\n" + a[..., 0].astype("<f4").tobytes()):
        assert like_cv2(tmp_path, data, ".pfm", "PFM") is None


# ---------------------------------------------------------------------------
# Sun raster

@pytest.mark.parametrize("kind", [RT_OLD, RT_STANDARD, RT_BYTE_ENCODED,
                                  RT_FORMAT_RGB])
def test_sun_raster(tmp_path, kind):
    rng = np.random.RandomState(kind)
    for h, w in ((4, 5), (3, 1), (7, 16), (2, 33)):
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        xbgr = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
        index = rng.randint(0, 256, (h, w)).astype(np.uint8)
        bits = rng.randint(0, 2, (h, w)).astype(np.uint8)
        cmap = rng.randint(0, 256, (3, 256))
        files = [sun_bytes(rgb, 24, kind), sun_bytes(xbgr, 32, kind),
                 sun_bytes(index, 8, kind), sun_bytes(bits, 1, kind),
                 sun_bytes(bits, 1, kind, cmap[:, :2]),
                 sun_bytes(bits, 1, kind, cmap[:, :3])]      # map too long
        files += [sun_bytes(index, 8, kind, cmap[:, :n])
                  for n in (1, 2, 100, 256)]
        for data in files:
            got = like_cv2(tmp_path, data, ".ras", "Sun raster")
            assert (got is not None) == (kind in (RT_OLD, RT_STANDARD)
                                         and data is not files[5])


def test_sun_raster_header(tmp_path):
    rng = np.random.RandomState(7)
    rgb = rng.randint(0, 256, (4, 5, 3)).astype(np.uint8)
    index = rng.randint(0, 256, (4, 5)).astype(np.uint8)
    path = tmp_path / "w.ras"
    assert cv2.imwrite(str(path), rgb[..., ::-1])
    assert like_cv2(tmp_path, path.read_bytes(), ".ras", "Sun raster") \
        is not None
    for data, reads in (
            (sun_bytes(index, 8, RT_STANDARD, np.arange(10)), True),
            (sun_bytes(rgb, 24, 1) + b"more", True),
            (sun_bytes(index, 8, 1, length=0), True),
            (sun_bytes(index, 8, 1, np.zeros((3, 4)), maptype=2), False),
            (sun_bytes(rgb, 24, 1, np.zeros((3, 4))), False),
            (sun_bytes(rgb, 24, 1)[:-1], False)):
        assert (like_cv2(tmp_path, data, ".ras", "Sun raster") is not None) \
            == reads
    for bpp in (2, 4, 16):
        data = bytearray(sun_bytes(index, 8, 1))
        data[12:16] = struct.pack(">I", bpp)
        assert like_cv2(tmp_path, bytes(data), ".ras", "Sun raster") is None


# ---------------------------------------------------------------------------
# Radiance HDR

def _rgbe(rng, h, w, exponents=(118, 140)):
    x = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    x[..., 3] = rng.randint(*exponents, (h, w))
    x[0, 0, 3] = 0
    return x


def test_hdr_scanlines(tmp_path):
    rng = np.random.RandomState(8)
    for w in (1, 2, 7, 8, 9, 40, 300):
        for exponents in ((118, 140), (0, 256)):
            x = _rgbe(rng, 3, w, exponents)
            for rle in (True, False):
                assert like_cv2(tmp_path, hdr_bytes(x, rle), ".hdr",
                                "Radiance HDR") is not None
    x = np.repeat(_rgbe(rng, 4, 3), 7, axis=1)                 # long runs
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 21\n"
    for data in (hdr_bytes(x), head + hdr_rle_scanline(x[0]) + x[1:].tobytes(),
                 head + hdr_rle_scanline(x[0]) + hdr_rle_scanline(x[1])
                 + x[2:].tobytes()):
        assert like_cv2(tmp_path, data, ".hdr", "Radiance HDR") is not None
    img = rng.uniform(0, 1.5, (5, 12, 3)).astype(np.float32)
    path = tmp_path / "w.hdr"
    assert cv2.imwrite(str(path), img)
    assert like_cv2(tmp_path, path.read_bytes(), ".hdr", "Radiance HDR") \
        is not None


def test_hdr_header(tmp_path):
    rng = np.random.RandomState(9)
    x = _rgbe(rng, 5, 12)
    fmt = b"FORMAT=32-bit_rle_rgbe\n"
    for header, resolution, reads in (
            (b"#?RGBE\n" + fmt + b"\n", None, True),
            (b"#?RADIANCE\nGAMMA=1.0\nEXPOSURE=2\n" + fmt + b"\n", None, True),
            (b"#?RADIANCE\n" + fmt + b"EXPOSURE=2\n\n", None, True),
            (b"#?RADIANCE\n# " + b"x" * 200 + b"\n" + fmt + b"\n", None,
             True),
            (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n" + fmt + b"\n", None,
             True),
            (None, b"-Y5+X12\n", True), (None, b"-Y  5   +X  12 \n", True),
            (None, b"-Y 5 +X 12 extra\n", True),
            (None, b"-Y +5 +X 12\n", True),
            (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n", None, False),
            (b"#?RADIANCE\n\n" + fmt + b"\n", None, False),
            (b"#?RADIANCE\r\n" + fmt[:-1] + b"\r\n\r\n", None, False),
            (b"#?RADIANCE\n" + fmt + b"\n\n", None, False),
            (b"#?RADIANCE\n" + fmt + b"\x00\n", None, False),
            (None, b"+Y 5 +X 12\n", False), (None, b"-Y 5 -X 12\n", False),
            (None, b"+X 12 -Y 5\n", False), (None, b"-Y 0 +X 12\n", False)):
        data = hdr_bytes(x, header=header, resolution=resolution)
        assert (like_cv2(tmp_path, data, ".hdr", "Radiance HDR")
                is not None) == reads, (header, resolution)
    good = hdr_bytes(x)
    at = good.find(b"\x02\x02\x00\x0c")
    for data in (good[:-1], good[:at + 6], good[:at] + b"\x02\x02\x00\x0b"
                 + good[at + 4:], good[:at + 4] + b"\x00" + good[at + 5:]):
        assert like_cv2(tmp_path, data, ".hdr", "Radiance HDR") is None
