"""PNG, BMP, GIF, WebP, TIFF, JPEG 2000, AVIF, PNM, PAM, PFM, Sun raster
and Radiance HDR files read as ``cv2.imread(path, IMREAD_COLOR)`` reads
them, and the signatures that pick a reader.

``cv2.imread`` picks its decoder by the file's first bytes, not by its
name: a PNG named ``.jpg`` is read as a PNG.  :func:`sniff` names the
format the same way; ``native.decode_image`` reads JPEG with the port's
decoder and the others here (with the host library's inner loops), and
refuses a format cv2 reads that the port does not (OpenEXR, which the
cv2 of the tests lacks), naming it.

PNG (libpng through cv2): the chunks are read here -- a bad CRC fails a
critical chunk and drops an ancillary one, an unknown critical chunk
fails, a file that ends before IEND fails -- and the image data inflate
with ``zlib``; the host library's ``png_unfilter`` (``csrc/png_decode.cc``)
undoes the filters and Adam7 and expands every colour type and bit depth
to 8-bit RGB: 16-bit samples keep their high byte, alpha and tRNS are
dropped without compositing.  An ``eXIf`` chunk turns the image as cv2
turns it.

BMP (cv2's own ``BmpDecoder``): BI_RGB at 1, 4, 8, 16 (5-5-5), 24 and 32
bits (the fourth byte dropped), BI_BITFIELDS at 16 bits with the 5-5-5 or
5-6-5 masks and at 32 bits (read as BGRA whatever the masks), RLE8 and
RLE4 (whose delta and end-of-bitmap escapes cv2 runs as "skip to the
row's end", moving down no row), bottom-up or top-down, the OS/2 header;
5- and 6-bit channels shift up without replicating their high bits, as
cv2 does.

WebP (libwebp through cv2, :func:`read_webp`): the RIFF container, VP8X
and animation chunks here, the VP8 and VP8L bitstreams in the host
library (``csrc/webp_decode.cc``).

TIFF (libtiff's RGBA interface through cv2, :func:`read_tiff`): the IFD,
strips and tiles, Deflate, libtiff's sample rules, its YCbCr, CMYK and
CIELab conversions and 24-bit LogLuv here; LZW, PackBits, CCITT fax,
ThunderScan and SGILog's run-length planes in the
host library (``csrc/tiff_decode.cc``), JPEG strips and tiles by the
JPEG decoder (``csrc/jpeg_decode.cc::jpeg_decode_tiff``).

JPEG 2000 (OpenJPEG 2.5 through cv2, :func:`read_jp2`): the JP2 boxes,
the palette, channel definitions and cv2's conversion to 8-bit here; the
codestream in the host library (``csrc/jp2_decode.cc``).

GIF (cv2 5's own ``GifDecoder``, :func:`read_gif`): the blocks, the
canvas and the colours here; the LZW codes in the host library
(``csrc/gif_decode.cc``).

AVIF (libavif 1.4 through cv2, :func:`read_avif`): the HEIF boxes and
libavif's YUV -> RGB (libyuv's fixed point and bilinear chroma, or its
own float path) here; the AV1 stream in the host library
(``csrc/av1_decode.cc``).

PNM, PAM, PFM, Sun raster and Radiance HDR (cv2's own decoders,
:func:`read_pnm`, :func:`read_pam`, :func:`read_pfm`, :func:`read_sun`,
:func:`read_hdr`): numpy here, with cv2's quirks.  None of these formats
carries EXIF that cv2 reads.
"""

from __future__ import annotations

import math
import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# the other formats cv2.imread reads: (name, test on the head)
_OTHERS = (
    ("GIF", lambda h: h[:6] in (b"GIF87a", b"GIF89a")),
    ("WebP", lambda h: h[:4] == b"RIFF" and h[8:12] == b"WEBP"),
    ("TIFF", lambda h: h[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00",
                                 b"MM\x00+")),
    ("JPEG 2000", lambda h: h[:12] == JP2_SIGNATURE
     or h[:4] == J2K_SIGNATURE),
    ("AVIF", lambda h: avif_brand(h)),
    ("OpenEXR", lambda h: h[:4] == b"\x76\x2f\x31\x01"),
    ("PNM", lambda h: len(h) > 1 and h[:1] == b"P" and h[1:2] in b"123456"),
    ("PAM", lambda h: h[:2] == b"P7"),
    ("PFM", lambda h: h[:2] in (b"Pf", b"PF")),
    ("Sun raster", lambda h: h[:4] == b"\x59\xa6\x6a\x95"),
    ("Radiance HDR", lambda h: h.startswith((b"#?RADIANCE", b"#?RGBE"))),
)


def sniff(head: bytes) -> str:
    """The format of a file from its first bytes, as cv2 picks its
    decoder: "JPEG", "PNG", "BMP", another name, or "" for none."""
    if head[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if head[:8] == PNG_SIGNATURE:
        return "PNG"
    if head[:2] == b"BM":
        return "BMP"
    for name, test in _OTHERS:
        if test(head):
            return name
    return ""


class FormatError(ValueError):
    """A file cv2 would not read either; the caller names the format."""


# cv2.imread's limits on the size a header gives (validateInputImageSize,
# under the defaults of OPENCV_IO_MAX_IMAGE_WIDTH, _HEIGHT and _PIXELS)
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


def check_size(w: int, h: int) -> None:
    """Refuse a header's size as cv2.imread refuses it, before anything
    of that size is made."""
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE and w * h <= MAX_PIXELS):
        raise FormatError(f"a {w}x{h} image, larger than cv2 reads")


# ---------------------------------------------------------------------------
# PNG

_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def read_png(data: bytes, unfilter, exif_orientation
             ) -> Tuple[np.ndarray, int]:
    """PNG bytes -> (uint8 [H, W, 3] RGB, EXIF orientation or 0), with the
    host library's ``png_unfilter(raw, w, h, depth, color_type,
    interlace, palette) -> rgb`` and ``exif_orientation(tiff) -> int``."""
    pos, ihdr, palette, idat, orientation = 8, None, b"", [], 0
    while True:
        if pos + 8 > len(data):
            raise FormatError("the file ends before the IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if length > 0x7FFFFFFF or pos + 12 + length > len(data):
            raise FormatError(f"the file ends inside the {ctype!r} chunk")
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        pos += 12 + length
        critical = not ctype[0] & 0x20
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            if critical:
                raise FormatError(f"{ctype.decode(errors='replace')}: CRC "
                                  f"error")
            continue                           # libpng drops the chunk
        if ihdr is None and ctype != b"IHDR":
            raise FormatError("IHDR is not the first chunk")
        if ctype == b"IHDR":
            if ihdr is not None or length != 13:
                raise FormatError("bad IHDR chunk")
            ihdr = struct.unpack(">IIBBBBB", body)
            w, h, depth, color, comp, filt, interlace = ihdr
            if (not 0 < w <= 1000000 or not 0 < h <= 1000000
                    or depth not in _DEPTHS.get(color, ()) or comp or filt
                    or interlace > 1):
                raise FormatError(f"bad IHDR: {ihdr}")
            check_size(w, h)
        elif ctype == b"PLTE":
            palette = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        elif ctype == b"eXIf":
            if not orientation:
                orientation = exif_orientation(body)
        elif critical:
            raise FormatError(f"{ctype.decode(errors='replace')}: unhandled "
                              f"critical chunk")
    w, h, depth, color, _, _, interlace = ihdr
    if color == 3 and not palette:
        raise FormatError("a palette image without a PLTE chunk")
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise FormatError(f"IDAT: {e}") from None
    return unfilter(raw, w, h, depth, color, interlace,
                    palette[:len(palette) // 3 * 3]), orientation


# ---------------------------------------------------------------------------
# BMP

_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


def _u32(data: bytes, at: int) -> int:
    if at + 4 > len(data):
        raise FormatError("the file ends inside its header")
    return struct.unpack("<i", data[at:at + 4])[0]


def read_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> uint8 [H, W, 3] RGB, as cv2's BmpDecoder reads them."""
    offset, size = _u32(data, 10), _u32(data, 14)
    palette = np.zeros((256, 3), np.uint8)          # BGR
    if size >= 36:
        w, h = _u32(data, 18), _u32(data, 22)
        bpp, rle, clrused = _u32(data, 26) >> 16 & 0xFFFF, _u32(data, 30), \
            _u32(data, 46)
        ok = w > 0 and h != 0 and (
            (bpp in (1, 4, 8, 24, 32) and rle == _RGB)
            or (bpp in (16, 32) and rle in (_RGB, _BITFIELDS))
            or (bpp == 4 and rle == _RLE4) or (bpp == 8 and rle == _RLE8))
        if not ok:
            raise FormatError(f"a {bpp}-bit BMP of compression {rle}")
        at = 14 + size
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise FormatError(f"{clrused} palette entries")
            n = clrused or 1 << bpp
            entries = np.frombuffer(data[at:at + 4 * n], np.uint8)
            if len(entries) < 4 * n:
                raise FormatError("the file ends inside its palette")
            palette[:n] = entries.reshape(n, 4)[:, :3]
        elif bpp == 16 and rle == _BITFIELDS:
            masks = (_u32(data, at), _u32(data, at + 4), _u32(data, at + 8))
            if masks == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif masks != (0xF800, 0x7E0, 0x1F):
                raise FormatError(f"16-bit masks {masks}")
        elif bpp == 16:
            bpp = 15
    elif size == 12:                                 # OS/2
        w, h = struct.unpack("<HH", data[18:22])
        bpp, rle = _u32(data, 22) >> 16 & 0xFFFF, _RGB
        if not (w > 0 and h > 0 and bpp in (1, 4, 8, 24, 32)):
            raise FormatError(f"an OS/2 BMP of {bpp} bits")
        if bpp <= 8:
            n = 1 << bpp
            entries = np.frombuffer(data[26:26 + 3 * n], np.uint8)
            if len(entries) < 3 * n:
                raise FormatError("the file ends inside its palette")
            palette[:n] = entries.reshape(n, 3)
    else:
        raise FormatError(f"a BMP header of {size} bytes")
    bottom_up, h = h > 0, abs(h)
    check_size(w, h)
    if rle in (_RLE8, _RLE4):
        img = _rle(data, offset, w, h, palette, rle == _RLE4)
    else:
        pitch = (w * (16 if bpp == 15 else bpp) + 7) // 8 + 3 & ~3
        rows = data[offset:offset + pitch * h]
        if offset < 0 or len(rows) < pitch * h:
            raise FormatError("the file ends inside its pixels")
        rows = np.frombuffer(rows, np.uint8).reshape(h, pitch)
        img = _unpack(rows, w, bpp, palette)
    if bottom_up:
        img = img[::-1]
    return np.ascontiguousarray(img[..., ::-1])


def _unpack(rows: np.ndarray, w: int, bpp: int,
            palette: np.ndarray) -> np.ndarray:
    """Uncompressed rows -> BGR."""
    if bpp <= 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * bpp].reshape(
            len(rows), w, bpp)
        index = (bits * (1 << np.arange(bpp - 1, -1, -1))).sum(-1)
        return palette[index]
    if bpp in (15, 16):
        t = rows[:, :2 * w].view("<u2").astype(np.int32)
        if bpp == 15:
            b, g, r = t << 3, (t >> 2) & ~7, (t >> 7) & ~7
        else:
            b, g, r = t << 3, (t >> 3) & ~3, (t >> 8) & ~7
        return (np.stack([b, g, r], -1) & 0xFF).astype(np.uint8)
    nb = bpp // 8
    return rows[:, :w * nb].reshape(len(rows), w, nb)[..., :3]


def _rle(data: bytes, offset: int, w: int, h: int, palette: np.ndarray,
         four: bool) -> np.ndarray:
    """RLE8 / RLE4 as cv2's BmpDecoder runs them: skipped and unfinished
    pixels take palette entry 0, a run or literal that overruns its row is
    an error, the end of the data before the end-of-bitmap escape too.
    Returns BGR rows in file order (the first row decoded first)."""
    img = np.empty((h, w, 3), np.uint8)
    flat = img.reshape(-1, 3)
    x = y = 0                   # where the next pixel goes
    line_end_flag = 0
    pos = offset

    def byte():
        nonlocal pos
        if pos >= len(data):
            raise FormatError("RLE data end before the end of the bitmap")
        pos += 1
        return data[pos - 1]

    def fill(count):            # FillUniColor with palette[0]
        nonlocal x, y
        while True:
            take = min(count, w - x)
            flat[y * w + x:y * w + x + take] = palette[0]
            x += take
            count -= take
            if x >= w:
                x, y = 0, y + 1
                if y >= h:
                    return
            if count <= 0:
                return

    while True:
        length, code = byte(), byte()
        if length:                                  # a run
            if x + length > w:
                raise FormatError("an RLE run past the end of its row")
            prev_y = y
            if four:
                pair = palette[[code >> 4, code & 15]]
                flat[y * w + x:y * w + x + length] = pair[np.arange(length) & 1]
                x += length
            else:
                fill_color = palette[code]
                flat[y * w + x:y * w + x + length] = fill_color
                x += length
                if x >= w:
                    x, y = 0, y + 1
                line_end_flag = y - prev_y
                if y >= h:
                    break
        elif code > 2:                              # literal pixels
            if x + code > w:
                raise FormatError("RLE literals past the end of their row")
            n = ((code + 1) // 2 + 1) & ~1 if four else (code + 1) & ~1
            raw = bytes(byte() for _ in range(n))
            if four:
                idx = np.frombuffer(raw, np.uint8)
                idx = np.stack([idx >> 4, idx & 15], -1).reshape(-1)[:code]
            else:
                idx = np.frombuffer(raw, np.uint8)[:code]
            flat[y * w + x:y * w + x + code] = palette[idx]
            x += code
            line_end_flag = 0
        else:                                       # escapes
            shift, y_shift = w - x, h - y
            if code == 2:
                shift, y_shift = byte(), byte()
            if four or code or not line_end_flag or shift < w:
                # cv2's RLE4 moves down only by filling to a row's end: its
                # delta and end-of-bitmap escapes skip no rows
                count = shift + (y_shift * w if code and not four else 0)
                if not four and y >= h:
                    break
                fill(count)
                if y >= h:
                    break
            line_end_flag = 0
            if y >= h:
                break
    return img


# ---------------------------------------------------------------------------
# WebP

def _le24(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8 | b[at + 2] << 16


def _le32(b: bytes, at: int) -> int:
    return struct.unpack("<I", b[at:at + 4])[0]


def _webp_chunks(data: bytes, pos: int, end: int):
    """(tag, payload offset, payload size) of each whole chunk from pos."""
    while pos + 8 <= end:
        size = _le32(data, pos + 4)
        if pos + 8 + size > end:
            raise FormatError(f"the file ends inside the {data[pos:pos + 4]!r}"
                              f" chunk")
        yield data[pos:pos + 4], pos + 8, size
        pos += 8 + size + (size & 1)


def _webp_image(data: bytes, at: int, size: int) -> Tuple[str, int, int]:
    """A VP8 or VP8L chunk's kind and size from its header, checked as
    libwebp's WebPGetFeatures checks it."""
    body = data[at:at + size]
    if data[at - 8:at - 4] == b"VP8 ":
        if size < 10 or body[3:6] != b"\x9d\x01\x2a":
            raise FormatError("bad VP8 frame header")
        bits = _le24(body, 0)
        if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or \
                bits >> 5 >= size:
            raise FormatError("bad VP8 frame header")
        w = struct.unpack("<H", body[6:8])[0] & 0x3FFF
        h = struct.unpack("<H", body[8:10])[0] & 0x3FFF
        if not w or not h:
            raise FormatError("a VP8 frame of size 0")
        return "VP8", w, h
    if size < 5 or body[0] != 0x2F or body[4] >> 5:
        raise FormatError("bad VP8L header")
    v = _le32(body, 1)
    return "VP8L", (v & 0x3FFF) + 1, (v >> 14 & 0x3FFF) + 1


def _webp_frame_chunks(data: bytes, chunks) -> Tuple[Optional[tuple], tuple]:
    """A frame's (ALPH chunk or None, image chunk) as libwebp's demuxer
    stores them: at most one ALPH, then the VP8 or VP8L chunk (a VP8L
    after an ALPH is an error); anything else ends the frame."""
    alpha = None
    for chunk in chunks:
        tag = chunk[0]
        if tag == b"ALPH" and alpha is None:
            alpha = chunk
        elif tag in (b"VP8 ", b"VP8L"):
            if tag == b"VP8L" and alpha is not None:
                raise FormatError("an ALPH chunk before a VP8L image")
            return alpha, chunk
        else:
            break
    raise FormatError("a frame without a VP8 or VP8L chunk")


def read_webp(data: bytes, vp8, vp8l, vp8l_alpha, exif_orientation
              ) -> Tuple[np.ndarray, int]:
    """WebP bytes -> (uint8 [H, W, 3] RGB, EXIF orientation or 0), as
    cv2.imread reads them through libwebp: the RIFF size bounds the file
    (a file shorter than it fails, bytes past it are ignored); a simple
    file's first chunk is VP8 or VP8L; a VP8X file's canvas must be its
    image's size, the last ALPH chunk before a VP8 image must decode
    (libwebp decodes it for cv2's BGRA output, whose alpha cv2 then
    drops), and with the EXIF flag the first EXIF chunk's orientation
    turns the image.  An animation gives its first frame on a canvas of
    transparent black.  The host library's ``vp8(body, w, h)``,
    ``vp8l(body, w, h)`` and ``vp8l_alpha(stream, w, h)`` decode the
    bitstreams."""
    if len(data) < 12:
        raise FormatError("the file ends inside the RIFF header")
    riff = _le32(data, 4)
    if riff < 12 or riff > 0xFFFFFFF6:
        raise FormatError(f"RIFF size {riff}")
    if riff > len(data) - 8:
        raise FormatError("the file ends before its RIFF size")
    end = riff + 8
    first = data[12:16]

    def decode(alpha, image) -> np.ndarray:
        _, at, size = image
        kind, w, h = _webp_image(data, at, size)
        body = data[at:at + size]
        if kind == "VP8L":
            return vp8l(body, w, h)
        if alpha is not None:              # libwebp decodes it, cv2 drops it
            stream = data[alpha[1]:alpha[1] + alpha[2]]
            if len(stream) <= 1:
                raise FormatError("an empty ALPH chunk")
            method, pre, rsrv = stream[0] & 3, stream[0] >> 4 & 3, \
                stream[0] >> 6
            if method > 1 or pre > 1 or rsrv:
                raise FormatError(f"bad ALPH header {stream[0]:#04x}")
            if method == 0 and len(stream) - 1 < w * h:
                raise FormatError("the ALPH chunk ends early")
            if method == 1:
                vp8l_alpha(stream[1:], w, h)
        return vp8(body, w, h)

    if first != b"VP8X":
        chunks = list(_webp_chunks(data, 12, end))
        if not chunks or chunks[0][0] not in (b"VP8 ", b"VP8L"):
            raise FormatError("no VP8 or VP8L chunk first")
        return decode(None, chunks[0]), 0
    if len(data) < 30 or _le32(data, 16) != 10:
        raise FormatError("bad VP8X chunk")
    flags = _le32(data, 20)
    cw, ch = _le24(data, 24) + 1, _le24(data, 27) + 1
    check_size(cw, ch)
    chunks = list(_webp_chunks(data, 30, end))
    orientation = 0
    if flags & 0x08:
        for tag, at, size in chunks:
            if tag == b"EXIF":
                orientation = exif_orientation(data[at:at + size])
                break
    if not flags & 0x02:
        # libwebp's decoder skips other chunks up to the image, the last
        # ALPH before it holding a VP8 image's alpha
        alpha = None
        for chunk in chunks:
            if chunk[0] == b"ALPH":
                alpha = chunk
            elif chunk[0] in (b"VP8 ", b"VP8L"):
                _, w, h = _webp_image(data, chunk[1], chunk[2])
                if (w, h) != (cw, ch):
                    raise FormatError(f"a {w}x{h} image on a {cw}x{ch} "
                                      f"canvas")
                return decode(alpha, chunk), orientation
        raise FormatError("no VP8 or VP8L chunk")
    # an animation, as libwebp's demuxer checks it (ANIM before the
    # frames, each frame's image inside the canvas at its offset) and its
    # animation decoder gives the first frame: on transparent black
    frames = []
    for tag, at, size in chunks:
        if tag == b"ANIM" and size < 6:
            raise FormatError("a short ANIM chunk")
        if tag == b"ANMF":
            if not any(c[0] == b"ANIM" and c[1] < at for c in chunks):
                raise FormatError("an ANMF chunk before the ANIM chunk")
            if size < 16:
                raise FormatError("a short ANMF chunk")
            alpha, image = _webp_frame_chunks(
                data, _webp_chunks(data, at + 16, at + size))
            _, w, h = _webp_image(data, image[1], image[2])
            x, y = 2 * _le24(data, at), 2 * _le24(data, at + 3)
            if x + w > cw or y + h > ch:
                raise FormatError("a frame outside the canvas")
            frames.append((x, y, w, h, alpha, image))
    if not frames:
        raise FormatError("an animation without frames")
    x, y, w, h, alpha, image = frames[0]
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[y:y + h, x:x + w] = decode(alpha, image)
    return canvas, orientation


# ---------------------------------------------------------------------------
# TIFF

# entry type -> (struct code, bytes)
_TIFF_TYPE = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4),
              5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
              9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
              13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                 32773: "PackBits", 2: "CCITT RLE", 3: "CCITT Group 3",
                 4: "CCITT Group 4", 6: "old JPEG", 7: "JPEG",
                 34676: "SGILog", 34677: "SGILog24", 32809: "ThunderScan",
                 32766: "NeXT", 34925: "LZMA", 50000: "Zstandard",
                 50001: "WebP", 34712: "JPEG 2000", 34892: "lossy JPEG"}
_PHOTOMETRICS = {0: "MINISWHITE", 1: "MINISBLACK", 2: "RGB", 3: "palette",
                 4: "mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab",
                 9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}


def _tiff_ifd(data: bytes) -> dict:
    """The first IFD of a classic or BigTIFF file: {tag: [values]}."""
    e = "<" if data[:2] == b"II" else ">"
    big = struct.unpack(e + "H", data[2:4])[0] == 43
    try:
        if big:
            if struct.unpack(e + "HH", data[4:8]) != (8, 0):
                raise FormatError("bad BigTIFF header")
            at = struct.unpack(e + "Q", data[8:16])[0]
            count = struct.unpack(e + "Q", data[at:at + 8])[0]
            at, size, inline = at + 8, 20, 8
        else:
            at = struct.unpack(e + "I", data[4:8])[0]
            count = struct.unpack(e + "H", data[at:at + 2])[0]
            at, size, inline = at + 2, 12, 4
    except struct.error:
        raise FormatError("the file ends inside its first IFD") from None
    if count == 0 or at + count * size > len(data):
        raise FormatError("the file ends inside its first IFD")
    tags = {}
    for k in range(count):
        ent = data[at + k * size:at + (k + 1) * size]
        tag, typ = struct.unpack(e + "HH", ent[:4])
        n = struct.unpack(e + ("Q" if big else "I"), ent[4:4 + inline])[0]
        if typ not in _TIFF_TYPE:
            continue
        code, width = _TIFF_TYPE[typ]
        nbytes = n * width
        if nbytes <= inline:
            raw = ent[4 + inline:4 + inline + nbytes]
        else:
            off = struct.unpack(e + ("Q" if big else "I"),
                                ent[4 + inline:4 + 2 * inline])[0]
            raw = data[off:off + nbytes]
            if len(raw) < nbytes:
                raise FormatError(f"the file ends inside tag {tag}'s values")
        tags[tag] = list(struct.unpack(e + code * n, raw))
    return tags, e


def _tiff_kind(photometric: int, bits, compression: int) -> str:
    return (f"a TIFF image ({_PHOTOMETRICS.get(photometric, photometric)}, "
            f"{'/'.join(map(str, sorted(set(bits))))}-bit samples, "
            f"{_COMPRESSIONS.get(compression, compression)} compression)")


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                     np.uint8)


def read_tiff(data: bytes, codecs) -> np.ndarray:
    """TIFF bytes (classic or BigTIFF, either byte order) -> uint8 [H, W,
    3] RGB, as cv2.imread reads the first page: through libtiff 4.7's RGBA
    interface (TIFFReadRGBAStrip / Tile), which cv2 asks for whenever its
    output is 8-bit.

    That interface takes grey (MINISBLACK, MINISWHITE inverted) at 1, 8
    and 16 bits (16-bit grey by its high byte; grey in tiles whose right
    part is clipped as libtiff's grey routines misstep over it), planar
    grey and RGB at 8 and 16 bits (16-bit samples become (v + 128) // 257)
    with alpha (associated: kept; unassociated: multiplied into the
    colour, as libtiff's UaToAa table rounds it; a fourth RGB sample
    without an ExtraSamples tag, or an unspecified one past 3 samples,
    counts as associated), palettes of 1, 4 and 8 bits (a colour map with
    any entry above 255 is read by its high byte), 8-bit CMYK of InkSet 1,
    chunky with 4 or more samples or planar with 4 (k = 255 - K, r = k *
    (255 - C) // 255), 8-bit YCbCr, chunky at YCbCrSubsampling 1, 2 or 4
    each way (4x2 at most: 44, 42, 41, 22, 21, 12, 11; the data units
    packed, chroma replicated over a unit) or planar at 1x1, through
    libtiff's TIFFYCbCrToRGB tables from ReferenceBlackWhite and
    YCbCrCoefficients, 8- and 16-bit CIELab of 3 samples through its
    float TIFFCIELabToXYZ and TIFFXYZToRGB under the WhitePoint (D50
    without one), and SGILog LogL and 32-bit LogLuv (``sgilog``: tif_luv.c's
    byte planes) and 24-bit LogLuv (SGILog24: 3 bytes a pixel, a 10-bit
    log luminance and a 14-bit uv cell), tone-mapped to 8 bits as
    tif_luv.c does for the RGBA reader; cv2 refuses 2- and 4-bit grey.
    Strips or tiles, chunky
    or planar, compressions none, LZW (the host library's ``lzw``, the old
    LSB-first kind too), Deflate (zlib), PackBits (``packbits``), JPEG
    (``jpeg``: the JPEGTables stream, then each strip's or tile's own,
    photometric YCbCr converted to RGB by the decoder as libjpeg converts
    it for libtiff, other photometrics' samples as stored) and CCITT RLE,
    Group 3 (1-D and 2-D) and Group 4 (``fax``, 1-bit samples); predictor
    2 (horizontal differencing, 8 and 16 bits) only where libtiff's codec
    honours it (LZW and Deflate), FillOrder 2 (each byte's bits reversed
    before the codec; the fax codec reads them in that order).  The
    Orientation tag: 2 and 3 flip each strip or tile left to right (the
    RGBA reader's flip), 3 and 4 then flip the image upside down (cv2's);
    cv2 fails on 5 to 8 (a turned image of another shape), and so does
    this reader.  SampleFormat 2 (signed) reads as unsigned.

    Damaged files read as cv2 reads them, one TIFFReadRGBAStrip / Tile a
    strip or tile: a codec that fails a strip leaves what it wrote, zeros
    after, without the predictor or the byte swap, and the image goes on;
    a byte count of 0 or past the file's end fails the image, as does an
    uncompressed tile whose count is not the tile's; an uncompressed
    file's counts that TIFFReadDirectory finds wrong are re-estimated
    (:func:`_tiff_counts`).

    Other kinds raise :class:`FormatError` naming themselves; those cv2
    refuses as well: LZMA, Zstandard, WebP and old-JPEG compression (not
    configured in cv2's libtiff), NeXT (2-bit), float and 32-bit samples,
    mixed SampleFormats, predictor 3, 16-bit CMYK and YCbCr, photometric
    RGB over a JPEG whose component 0 is sampled above 1x1."""
    tags, e = _tiff_ifd(data)

    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    w, h = one(256), one(257)
    if not w or not h:
        raise FormatError("no ImageWidth or ImageLength")
    check_size(w, h)
    spp = one(277, 1)
    bits = tags.get(258) or [1] * spp
    compression = one(259, 1)
    photometric = one(262)
    if photometric is None:
        photometric = 1 if spp == 1 else 2 if spp == 3 else None
        if photometric is None:
            raise FormatError("no PhotometricInterpretation")
    kind = _tiff_kind(photometric, bits, compression)
    bps = bits[0]
    planar = one(284, 1) if spp > 1 else 1
    predictor = one(317, 1) if compression in (5, 8, 32946) else 1
    sample_format = one(339, 1)
    if len(set(tags.get(339, [1]))) != 1:
        raise FormatError(f"{kind} of sample formats {tags[339]}, which "
                          f"libtiff refuses (one value for every sample)")
    fax = compression in (2, 3, 4)
    if compression in (6, 34925, 50000, 50001):
        raise FormatError(f"{kind}, which cv2 does not read either (its "
                          f"libtiff has no such codec configured)")
    if compression == 32766:
        raise FormatError(f"{kind}, which cv2 does not read either (NeXT "
                          f"holds 2-bit samples)")
    if compression not in (1, 2, 3, 4, 5, 7, 8, 32946, 32773, 32809,
                           34676, 34677):
        raise FormatError(f"{kind}, which the port does not read")
    # SGILog: libtiff's RGBA reader asks tif_luv.c for 8-bit grey (LogL)
    # or RGB (LogLuv), tone-mapped by 256 * sqrt(Y); sgilog is the bytes a
    # stored pixel: 2 LogL, 4 LogLuv, 3 24-bit LogLuv
    sgilog = 0
    if photometric in (32844, 32845):
        if compression not in (34676, 34677) or \
                (photometric == 32844 and compression != 34676):
            raise FormatError(f"{kind}, which libtiff's RGBA reader refuses "
                              f"(LogL and LogLuv need SGILog compression)")
        if (photometric, spp) not in ((32844, 1), (32845, 3)) or \
                one(284, 1) != 1:
            raise FormatError(f"{kind} of {spp} samples, planar "
                              f"configuration {one(284, 1)}, which cv2 does "
                              f"not read either")
        sgilog = 2 if photometric == 32844 else \
            3 if compression == 34677 else 4
        photometric, bits, bps = (1 if sgilog == 2 else 2), [8] * spp, 8
        sample_format = 1
    elif compression == 34676:
        raise FormatError(f"{kind}, which libtiff's SGILog codec refuses "
                          f"(LogL or LogLuv data only)")
    if compression == 32809 and (one(258, 1) != 4 or spp != 1):
        raise FormatError(f"{kind}, which libtiff's ThunderScan codec "
                          f"refuses (4-bit samples only)")
    if photometric not in (0, 1, 2, 3, 5, 6, 8):
        raise FormatError(f"{kind}, which the port does not read")
    # cv2 takes 1, 8 and 16 bits, and 4 in a palette
    if len(set(bits)) != 1 or bps not in ((1, 4, 8) if photometric == 3
                                          else (1, 8, 16)) or \
            sample_format not in (1, 2) or planar not in (1, 2):
        raise FormatError(f"{kind} of sample format {sample_format}, planar "
                          f"configuration {planar}, which the port does not "
                          f"read")
    if fax and (bps != 1 or spp != 1):
        raise FormatError(f"{kind} of {spp} samples, which libtiff's fax "
                          f"codec refuses (1-bit samples only)")
    if compression == 7 and bps != 8:
        raise FormatError(f"{kind}, which libtiff's JPEG codec refuses "
                          f"(improper JPEG data precision)")
    if predictor not in (1, 2) or (predictor == 2 and bps < 8):
        raise FormatError(f"{kind} with predictor {predictor}, which the "
                          f"port does not read")
    if photometric == 2 and spp > 4:
        raise FormatError(f"{kind} of {spp} samples, which cv2 does not "
                          f"read either")
    if photometric == 2 and (bps < 8 or spp < 3):
        raise FormatError(f"{kind} of {spp} samples, which cv2 does not "
                          f"read either")
    if photometric == 3 and len(tags.get(320, ())) != 3 << bps:
        raise FormatError(f"{kind} without a colour map of {1 << bps} "
                          f"entries")
    if photometric in (0, 1, 3) and spp > 1 and (bps < 8 or (
            planar == 2 and photometric == 3)):
        raise FormatError(f"{kind} of {spp} samples, which the port does "
                          f"not read")
    if photometric == 5 and (one(332, 1) != 1 or spp != 4 or bps != 8):
        raise FormatError(f"{kind} of {spp} samples, InkSet {one(332, 1)}, "
                          f"planar configuration {planar}, which cv2 does "
                          f"not read either")
    if photometric == 8 and (spp != 3 or bps == 1 or planar != 1):
        raise FormatError(f"{kind} of {spp} samples, planar configuration "
                          f"{planar}, which cv2 does not read either")
    hs, vs = 1, 1
    if photometric == 6:
        sub = tags.get(530)
        if sub is None and compression == 7:
            hs, vs = _jpeg_sampling(data, tags)
        elif sub is not None:
            hs, vs = (list(sub) + [2])[:2]
        else:
            hs, vs = 2, 2
        # libtiff's put routines: 44, 42, 41, 22, 21, 12, 11 chunky, 11
        # planar; libjpeg's RGB of a JPEG any sampling, chunky
        if spp != 3 or bps != 8 or hs not in (1, 2, 4) or \
                vs not in (1, 2, 4) or (compression != 7 and (
                    vs > hs and (hs, vs) != (1, 2) or
                    planar == 2 and (hs, vs) != (1, 1))) or \
                (planar == 2 and compression == 7):
            raise FormatError(f"{kind} of {spp} samples, subsampling "
                              f"{hs}x{vs}, planar configuration {planar}, "
                              f"which cv2 does not read either")
    # libtiff's alpha: ExtraSamples' first, unspecified counting as
    # associated past 3 samples, and a fourth RGB sample without the tag
    extra = tags.get(338) or []
    if extra:
        alpha = extra[0] if extra[0] in (1, 2) else int(spp > 3)
    else:
        alpha = int(spp == 4 and photometric == 2)
    # libtiff's grey "put" routines step over a tile's clipped right part
    # by its width in samples, not bytes: each row after the first reads
    # from where it lands (a no-op for one 8-bit sample)
    skewed = photometric in (0, 1) and planar == 1
    fill_order = one(266, 1)
    orientation = one(274, 1)
    if orientation in (5, 6, 7, 8):
        raise FormatError(f"{kind} with Orientation {orientation}, which "
                          f"cv2.imread fails on")
    tiled = 322 in tags
    if tiled:
        tw, th = one(322), one(323)
        offsets, counts = tags.get(324), tags.get(325)
        if not tw or not th or tw % 16 or th % 16:
            raise FormatError(f"bad tile size {tw}x{th}")
        across, down = -(-w // tw), -(-h // th)
    else:
        rps = min(one(278, h) or h, h)
        offsets, counts = tags.get(273), tags.get(279)
        tw, th, across, down = w, rps, 1, -(-h // rps)
    nplanes = spp if planar == 2 else 1
    chunk_spp = 1 if planar == 2 else spp
    if not offsets or not counts or \
            len(offsets) < across * down * nplanes or \
            len(counts) < across * down * nplanes:
        raise FormatError("missing or short strip or tile offsets")
    # photometric YCbCr: libtiff asks libjpeg for RGB, else packed units
    ycbcr_units = photometric == 6 and compression != 7 and \
        (hs, vs) != (1, 1)
    if photometric == 6 and compression == 7:
        photometric = 2                 # the decoder's RGB
    row_bytes = (tw * chunk_spp * bps + 7) // 8
    scanline = (-(-tw // hs) * (hs * vs + 2)) // vs if ycbcr_units \
        else row_bytes                      # TIFFScanlineSize
    counts = _tiff_counts(list(counts), offsets, len(data), compression,
                          tiled, planar, scanline, h, down,
                          _ycbcr_chunk_size(tw, th, hs, vs, True)
                          if ycbcr_units else row_bytes * th)
    dtype = np.dtype(e + "u2") if bps == 16 else np.dtype(np.uint8)
    planes = np.zeros((nplanes, h, w, chunk_spp),
                      np.uint16 if bps == 16 else np.uint8)
    fax_state = {}                      # the fax codec's mode, image-wide
    for p in range(nplanes):
        for k in range(across * down):
            ty, tx = divmod(k, across)
            rows = th if tiled else min(th, h - ty * th)
            size = row_bytes * rows
            if ycbcr_units:
                size = _ycbcr_chunk_size(tw, rows, hs, vs, tiled)
            i = p * across * down + k
            # TIFFFillStrip / TIFFFillTile fail the image before the
            # strip's buffer exists
            if counts[i] == 0:
                raise FormatError(f"strip or tile {i} of 0 bytes")
            if offsets[i] + counts[i] > len(data):
                raise FormatError("the file ends inside a strip or tile")
            raw = data[offsets[i]:offsets[i] + counts[i]]
            if fill_order == 2 and not fax:     # libtiff reverses the bits
                raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            # ok False: the codec failed the strip, which cv2's libtiff
            # reads on with what it wrote (no predictor, no byte swap)
            if compression == 1:
                if tiled:
                    # libtiff wants an uncompressed tile's bytes read to be
                    # the tile's; with FillOrder 2 it reads them into its
                    # raw buffer, whose size it rounds up to 1024 bytes
                    got = -(-counts[i] // 1024) * 1024 if fill_order == 2 \
                        else counts[i]
                    if got != size:
                        raise FormatError(
                            f"{kind}: an uncompressed tile of {got} bytes "
                            f"read, not {size}, which libtiff refuses")
                ok = len(raw) >= size           # DumpModeDecode copies all
                buf = raw[:size] if ok else bytes(size)     # or nothing
            elif compression == 5:
                buf, ok = codecs["lzw"](raw, size)
            elif compression == 32773:
                buf, ok = codecs["packbits"](raw, size)
            elif fax:
                buf, ok = codecs["fax"](raw, rows, tw, compression,
                                        one(293 if compression == 4 else 292,
                                            0), fill_order, fax_state)
            elif compression == 32809:
                buf, ok = codecs["thunder"](raw, rows, tw)
            elif sgilog == 3:
                vals, ok = _sgilog24(raw, rows, tw)
                buf = _xyz_rgb(_logluv24_xyz(vals)).tobytes()
            elif sgilog:
                vals, ok = codecs["sgilog"](raw, rows, tw, sgilog)
                buf = (_logl_grey(vals) if sgilog == 2
                       else _logluv_rgb(vals)).tobytes()
            elif compression == 7:
                buf, ok = codecs["jpeg"](
                    bytes(tags.get(347, ())), raw, tw, rows, chunk_spp,
                    one(262) == 6, hs, vs,
                    not tiled and ty * th + rows == h)
            else:
                buf, ok = _inflate(raw, size)
            if ycbcr_units:
                s = _ycbcr_expand(buf, tw, rows, hs, vs,
                                  min(tw, w - tx * tw) if tiled else tw)
            elif compression == 7 and photometric == 2 and one(262) == 6:
                s = np.frombuffer(buf, np.uint8).reshape(rows, tw, 3)
            elif bps >= 8:
                s = np.frombuffer(buf, dtype if ok else np.dtype(
                    dtype.newbyteorder("<"))).reshape(rows, tw, chunk_spp)
                if predictor == 2 and ok:
                    s = np.cumsum(s, axis=1, dtype=dtype)
                if skewed and tiled and w - tx * tw < tw:
                    s = _tiff_skew(s, w - tx * tw, bps)
            else:
                bitrows = np.unpackbits(np.frombuffer(buf, np.uint8).reshape(
                    rows, row_bytes), axis=1)[:, :tw * bps]
                s = (bitrows.reshape(rows, tw, bps)
                     * (1 << np.arange(bps - 1, -1, -1))).sum(-1)[..., None]
            y0, x0 = ty * th, tx * tw
            hh, ww = min(rows, h - y0), min(tw, w - x0)
            s = s[:hh, :ww]
            if orientation in (2, 3):           # libtiff's RGBA reader
                s = s[:, ::-1]                  # flips each strip or tile
            planes[p, y0:y0 + hh, x0:x0 + ww] = s
    samples = planes[:, ..., 0].transpose(1, 2, 0) if planar == 2 \
        else planes[0]
    img = _tiff_rgb(samples, photometric, bps, tags, planar, alpha)
    if orientation in (3, 4):                   # and cv2 the whole image
        img = img[::-1]
    return np.ascontiguousarray(img)


_LOGL_Y = None


def _logl_y(le: np.ndarray) -> np.ndarray:
    """tif_luv.c's LogL16toY of 15-bit magnitudes, sign aside:
    exp(ln 2 / 256 * (Le + .5) - 64 ln 2), 0 for Le 0, by the C library's
    exp (``math.exp``) once for all 32768."""
    global _LOGL_Y
    if _LOGL_Y is None:
        ln2 = math.log(2)
        _LOGL_Y = np.array([0.0] + [math.exp(ln2 / 256. * (k + .5)
                                             - ln2 * 64.)
                                    for k in range(1, 32768)])
    return _LOGL_Y[le]


def _tone(v: np.ndarray) -> np.ndarray:
    """tif_luv.c's 8-bit tone map: 0 below 0, 255 from 1, else
    (int)(256 * sqrt(v))."""
    with np.errstate(invalid="ignore"):
        t = np.floor(256. * np.sqrt(np.clip(v, 0, 1)))
    return np.where(v <= 0, 0, np.where(v >= 1, 255, t)).astype(np.uint8)


def _logl_grey(p: np.ndarray) -> np.ndarray:
    """16-bit LogL -> grey (L16toGry): a set sign bit is negative, 0."""
    p = p.astype(np.int64)
    y = _logl_y(p & 0x7FFF)
    return _tone(np.where(p & 0x8000, -y, y))


def _logluv_rgb(p: np.ndarray) -> np.ndarray:
    """32-bit LogLuv -> RGB (Luv32toRGB): LogLuv32toXYZ's 16-bit LogL
    and (u, v) from two bytes, then XYZtoRGB24."""
    p = p.astype(np.int64)
    hi = p >> 16
    y = _logl_y(hi & 0x7FFF)
    return _xyz_rgb(_luv_xyz(np.where(hi & 0x8000, -y, y),
                             1. / 410 * (((p >> 8) & 0xFF) + .5),
                             1. / 410 * ((p & 0xFF) + .5)))


def _luv_xyz(L: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The tail of tif_luv.c's LogLuv32toXYZ and LogLuv24toXYZ: (u, v) to
    xy in double, then X, Y, Z each rounded to float (all 0 where L <=
    0) -> float32 [..., 3]."""
    s = 1. / (6. * u - 16. * v + 12.)
    x, y = 9. * u * s, 4. * v * s
    xyz = np.stack([x / y * L, L, (1. - x - y) / y * L], -1)
    return np.where((L > 0)[..., None], xyz, 0).astype(np.float32)


def _xyz_rgb(xyz: np.ndarray) -> np.ndarray:
    """tif_luv.c's XYZtoRGB24: the CCIR-709 matrix in double, then the
    tone map."""
    X, Y, Z = np.moveaxis(xyz.astype(np.float64), -1, 0)
    return np.stack([_tone(2.690 * X + -1.276 * Y + -0.414 * Z),
                     _tone(-1.022 * X + 1.978 * Y + 0.044 * Z),
                     _tone(0.061 * X + -0.224 * Y + 1.163 * Z)], -1)


# tif_luv.c's uvcode.h: the 163 rows of (u', v') cells of side UV_SQSIZ
# from v' = UV_VSTART, each row's first u' (a float) and the index of its
# first cell; indices from 16289 on are no cell
_UV_USTART = (
    0.247663, 0.243779, 0.241684, 0.237874, 0.235906, 0.232153, 0.228352,
    0.226259, 0.222371, 0.220410, 0.214710, 0.212714, 0.210721, 0.204976,
    0.202986, 0.199245, 0.195525, 0.193560, 0.189878, 0.186216, 0.186216,
    0.182592, 0.179003, 0.175466, 0.172001, 0.172001, 0.168612, 0.168612,
    0.163575, 0.158642, 0.158642, 0.158642, 0.153815, 0.153815, 0.149097,
    0.149097, 0.142746, 0.142746, 0.142746, 0.138270, 0.138270, 0.138270,
    0.132166, 0.132166, 0.126204, 0.126204, 0.126204, 0.120381, 0.120381,
    0.120381, 0.120381, 0.112962, 0.112962, 0.112962, 0.107450, 0.107450,
    0.107450, 0.107450, 0.100343, 0.100343, 0.100343, 0.095126, 0.095126,
    0.095126, 0.095126, 0.088276, 0.088276, 0.088276, 0.088276, 0.081523,
    0.081523, 0.081523, 0.081523, 0.074861, 0.074861, 0.074861, 0.074861,
    0.068290, 0.068290, 0.068290, 0.068290, 0.063573, 0.063573, 0.063573,
    0.063573, 0.057219, 0.057219, 0.057219, 0.057219, 0.050985, 0.050985,
    0.050985, 0.050985, 0.050985, 0.044859, 0.044859, 0.044859, 0.044859,
    0.040571, 0.040571, 0.040571, 0.040571, 0.036339, 0.036339, 0.036339,
    0.036339, 0.032139, 0.032139, 0.032139, 0.032139, 0.027947, 0.027947,
    0.027947, 0.023739, 0.023739, 0.023739, 0.023739, 0.019504, 0.019504,
    0.019504, 0.016976, 0.016976, 0.016976, 0.016976, 0.012639, 0.012639,
    0.012639, 0.009991, 0.009991, 0.009991, 0.009016, 0.009016, 0.009016,
    0.006217, 0.006217, 0.005097, 0.005097, 0.005097, 0.003909, 0.003909,
    0.002340, 0.002389, 0.001068, 0.001653, 0.000717, 0.001614, 0.000270,
    0.000484, 0.001103, 0.001242, 0.001188, 0.001011, 0.000709, 0.000301,
    0.002416, 0.003251, 0.003246, 0.004141, 0.005963, 0.008839, 0.010490,
    0.016994, 0.023659)
_UV_NCUM = (
    0, 4, 10, 17, 26, 36, 48, 62, 77, 94, 112, 133, 155, 178, 204, 231,
    260, 291, 323, 357, 393, 429, 467, 507, 549, 593, 637, 683, 729, 778,
    830, 882, 934, 989, 1044, 1102, 1160, 1222, 1284, 1346, 1411, 1476,
    1541, 1610, 1679, 1752, 1825, 1898, 1975, 2052, 2129, 2206, 2288, 2370,
    2452, 2538, 2624, 2710, 2796, 2887, 2978, 3069, 3164, 3259, 3354, 3449,
    3549, 3649, 3749, 3849, 3954, 4059, 4164, 4269, 4379, 4489, 4599, 4709,
    4824, 4939, 5054, 5169, 5288, 5407, 5526, 5645, 5769, 5893, 6017, 6141,
    6270, 6399, 6528, 6657, 6786, 6920, 7054, 7188, 7322, 7460, 7598, 7736,
    7874, 8016, 8158, 8300, 8442, 8588, 8734, 8880, 9026, 9176, 9326, 9476,
    9630, 9784, 9938, 10092, 10250, 10408, 10566, 10727, 10888, 11049,
    11210, 11375, 11540, 11705, 11873, 12041, 12209, 12379, 12549, 12719,
    12892, 13065, 13240, 13415, 13590, 13767, 13944, 14121, 14291, 14455,
    14612, 14762, 14905, 15041, 15170, 15293, 15408, 15517, 15620, 15717,
    15806, 15888, 15964, 16033, 16095, 16150, 16197, 16237, 16268)
_UV_CELLS = None


def _uv_cells() -> Tuple[np.ndarray, np.ndarray]:
    """uv_decode's (u', v') of every 14-bit index, in double: u' =
    ustart + (i + .5) UV_SQSIZ, v' = UV_VSTART + (row + .5) UV_SQSIZ,
    both constants floats; LogLuv24toXYZ's neutral (U_NEU, V_NEU) past
    the last cell."""
    global _UV_CELLS
    if _UV_CELLS is None:
        sq, v0 = float(np.float32(0.0035)), float(np.float32(0.01694))
        c = np.arange(16384)
        row = np.searchsorted(_UV_NCUM, c, "right") - 1
        u = np.array(_UV_USTART, np.float32).astype(np.float64)[row] + \
            (c - np.array(_UV_NCUM)[row] + .5) * sq
        v = v0 + (row + .5) * sq
        past = c >= 16289
        _UV_CELLS = (np.where(past, 0.210526316, u),
                     np.where(past, 0.473684211, v))
    return _UV_CELLS


_LOGL10_Y = None


def _logluv24_xyz(p: np.ndarray) -> np.ndarray:
    """tif_luv.c's LogLuv24toXYZ: the 10-bit Le of bits 14..23 through
    LogL10toY, exp(ln 2 / 64 (Le + .5) - 12 ln 2) by the C library's exp
    (0 for Le 0), and the uv cell of the low 14 bits (:func:`_uv_cells`)
    -> float32 [..., 3]."""
    global _LOGL10_Y
    if _LOGL10_Y is None:
        ln2 = math.log(2)
        _LOGL10_Y = np.array([0.0] + [math.exp(ln2 / 64. * (k + .5)
                                               - ln2 * 12.)
                                      for k in range(1, 1024)])
    p = p.astype(np.int64)
    u, v = _uv_cells()
    return _luv_xyz(_LOGL10_Y[(p >> 14) & 0x3FF], u[p & 0x3FFF],
                    v[p & 0x3FFF])


def _sgilog24(raw: bytes, rows: int, width: int) -> Tuple[np.ndarray, bool]:
    """tif_luv.c's LogLuvDecode24 on a strip or tile: each pixel 3 bytes,
    most significant first; a row the data do not fill fails, and it and
    the rows after stay 0 (False)."""
    whole = min(len(raw) // (3 * width), rows)
    b = np.frombuffer(raw, np.uint8, whole * width * 3).reshape(-1, 3)
    vals = np.zeros(rows * width, np.uint32)
    vals[:whole * width] = (b[:, 0].astype(np.uint32) << 16) | \
        (b[:, 1].astype(np.uint32) << 8) | b[:, 2]
    return vals, whole == rows


def _tiff_counts(counts: list, offsets: list, file_size: int,
                 compression: int, tiled: bool, planar: int, scanline: int,
                 h: int, per_plane: int, tile_size: int) -> list:
    """The byte counts libtiff reads: TIFFReadDirectory replaces an
    uncompressed file's byte counts that look wrong -- one strip of 0
    bytes, or past the file's end, or of fewer bytes than the image; or,
    chunky in more than two strips or tiles, a first and second count that
    differ -- by EstimateStripByteCounts: a tile's bytes, or the
    scanline's bytes times the image's rows over its strips (rounded
    down), every one alike."""
    if compression != 1 or not counts:
        return counts
    if len(counts) == 1:
        bad = not tiled and offsets[0] != 0 and (
            counts[0] == 0 or counts[0] > file_size - offsets[0]
            or counts[0] < scanline * h)
    else:
        bad = planar == 1 and len(counts) > 2 and counts[0] != counts[1] \
            and counts[0] != 0 and counts[1] != 0
    if not bad:
        return counts
    return [tile_size if tiled else scanline * (h // per_plane)] * \
        len(counts)


def _inflate(raw: bytes, size: int) -> Tuple[bytes, bool]:
    """libtiff's ZIPDecode into a zeroed strip of ``size`` bytes: zlib's
    inflate until the strip is full; where the data end first or are
    corrupt, what it wrote before (False)."""
    try:
        buf = zlib.decompressobj().decompress(raw, size)
        return buf + bytes(size - len(buf)), len(buf) == size
    except zlib.error:
        pass
    # the bytes inflate wrote before the error: fed one input byte a call
    d, buf = zlib.decompressobj(), bytearray()
    try:
        for i in range(len(raw)):
            buf += d.decompress(raw[i:i + 1], size - len(buf))
            if len(buf) >= size:
                break
    except zlib.error:
        pass
    return bytes(buf[:size]) + bytes(size - min(len(buf), size)), False


def _jpeg_sampling(data: bytes, tags: dict) -> Tuple[int, int]:
    """libtiff's JPEGFixupTagsSubsampling: a JPEG-compressed YCbCr TIFF
    without YCbCrSubsampling takes component 0's sampling factors from the
    frame header of its first strip or tile (2x2 where none is found)."""
    offsets = tags.get(324) or tags.get(273)
    counts = tags.get(325) or tags.get(279)
    if offsets and counts:
        seg = data[offsets[0]:offsets[0] + counts[0]]
        for m in re.finditer(rb"\xff[\xc0-\xc2\xc9\xca]", seg):
            f = seg[m.start() + 2:m.start() + 12]
            if len(f) == 10 and f[7] >= 1:
                return f[9] >> 4, f[9] & 15
    return 2, 2


def _ycbcr_chunk_size(tw: int, rows: int, hs: int, vs: int,
                      tiled: bool) -> int:
    """The bytes libtiff decodes into a strip or tile of subsampled YCbCr:
    whole data units of hs * vs luma and 2 chroma samples; a strip reads
    its rows rounded up to vs times TIFFScanlineSize, the units of a row
    over vs rounded down."""
    units = -(-tw // hs) * (hs * vs + 2)
    full = -(-rows // vs) * units
    if tiled:
        return full
    return min(full, -(-rows // vs) * vs * (units // vs))


def _ycbcr_expand(buf: bytes, tw: int, rows: int, hs: int, vs: int,
                  ww: int) -> np.ndarray:
    """Packed YCbCr units -> [rows, tw, 3] samples as libtiff's
    putcontig8bitYCbCr* routines spread them: each luma sample at its
    place in the unit, the unit's Cb and Cr over all of them; bytes past
    what the codec decoded are zero.  A tile clipped to ``ww`` columns is
    read as the routines step over it: the units that cover ww, then
    (tw - ww) // hs units skipped, which putcontig8bitYCbCr44tile counts
    as 10 bytes each, not 18."""
    ux, uy = -(-tw // hs), -(-rows // vs)
    n = hs * vs + 2
    flat = np.zeros(ux * uy * n, np.uint8)
    got = np.frombuffer(buf, np.uint8)[:flat.size]
    flat[:got.size] = got
    if ww < tw:
        used = -(-ww // hs)
        stride = used * n + (tw - ww) // hs * (10 if (hs, vs) == (4, 4)
                                               else n)
        at = (np.arange(uy)[:, None] * stride
              + np.arange(used * n)[None, :])
        u = np.zeros((uy, ux, n), np.uint8)
        u[:, :used] = flat[at].reshape(uy, used, n)
    else:
        u = flat.reshape(uy, ux, n)
    y = u[..., :hs * vs].reshape(uy, ux, vs, hs).transpose(0, 2, 1, 3)
    y = y.reshape(uy * vs, ux * hs)
    cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)
    return np.stack([y, cb, cr], -1)[:rows, :tw]


def _tiff_skew(s: np.ndarray, ww: int, bps: int) -> np.ndarray:
    """A tile [rows, tw, spp] as libtiff's skewed grey routines read its
    first ``ww`` columns: row r from byte r * (ww * pixel bytes + tw -
    ww), the grey sample at each pixel's first byte (8-bit) or the high
    byte of the little-endian word there (16-bit, held as v << 8)."""
    rows, tw, spp = s.shape
    raw = np.ascontiguousarray(s.astype("<u2" if bps == 16 else np.uint8)
                               ).view(np.uint8).reshape(-1)
    pixel = spp * (2 if bps == 16 else 1)
    at = (np.arange(rows)[:, None] * (ww * pixel + tw - ww)
          + np.arange(ww)[None, :] * pixel)
    out = np.zeros_like(s)
    out[:, :ww, 0] = raw[at + 1].astype(np.uint16) << 8 if bps == 16 \
        else raw[at]
    return out


def _to8(v: np.ndarray, bps: int) -> np.ndarray:
    """libtiff's Bitdepth16To8 for 16-bit samples."""
    return ((v.astype(np.int64) + 128) // 257) if bps == 16 else v


def _tiff_rgb(samples: np.ndarray, photometric: int, bps: int,
              tags: dict, planar: int, alpha: int) -> np.ndarray:
    """Samples [H, W, spp] -> RGB as libtiff's RGBA "put" routines make
    it (tif_getimage.c)."""
    spp = samples.shape[2]
    if photometric in (0, 1) and planar == 1:   # grey: the BW map
        g = samples[..., 0].astype(np.int64)
        if bps == 16:
            g >>= 8                             # the high byte
        top = 255 if bps >= 8 else (1 << bps) - 1
        g = (top - g if photometric == 0 else g) * 255 // top
        return np.repeat(g.astype(np.uint8)[..., None], 3, -1)
    if photometric == 5:                        # CMYK
        c = samples[..., :4].astype(np.int64)
        k = 255 - c[..., 3:]
        return (k * (255 - c[..., :3]) // 255).astype(np.uint8)
    if photometric == 6:                        # YCbCr
        return _ycbcr_rgb(samples, tags)
    if photometric == 8:                        # CIELab
        return _cielab_rgb(samples, bps, tags)
    if photometric == 3:                        # palette
        n = 1 << bps
        cmap = np.asarray(tags[320], np.int64)
        if len(cmap) < 3 * n:
            raise FormatError("a short colour map")
        cmap = cmap[:3 * n].reshape(3, n)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.T.astype(np.uint8)[samples[..., 0]]
    # RGB, and planar grey, which libtiff reads as RGB from one plane
    channels = 3 if photometric == 2 else 1
    if bps == 8 and channels == 3 and not (spp > 3 and alpha == 2):
        return samples[..., :3]
    rgb = _to8(samples[..., :channels], bps).astype(np.int64)
    if spp > channels and alpha == 2:           # unassociated: premultiply
        a = _to8(samples[..., channels:channels + 1], bps).astype(np.int64)
        rgb = (rgb * a + 127) // 255
    return np.repeat(rgb, 3 // channels, -1).astype(np.uint8)


def _rationals(tags: dict, tag: int, default) -> np.ndarray:
    """A RATIONAL tag as libtiff's float array: num / den in float32, 0
    for a zero denominator."""
    v = tags.get(tag)
    if not v or len(v) < 2 * len(default):
        return np.asarray(default, np.float32)
    num = np.asarray(v[0::2], np.float64).astype(np.float32)
    den = np.asarray(v[1::2], np.float64).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(den == 0, np.float32(0), num / den)
    return q.astype(np.float32)[:len(default)]


def _fix(x) -> int:
    """tif_color.c's FIX: (int32_t)(x * 65536.0F + 0.5) of a float."""
    return int(float(np.float32(x) * np.float32(65536)) + 0.5)


def _ycbcr_rgb(samples: np.ndarray, tags: dict) -> np.ndarray:
    """8-bit Y, Cb, Cr -> RGB by libtiff's TIFFYCbCrToRGBInit tables and
    TIFFYCbCrtoRGB: the YCbCrCoefficients (0.299, 0.587, 0.114 without
    the tag) and ReferenceBlackWhite (0, 255, 128, 255, 128, 255) in float
    arithmetic, 16-bit fixed point after."""
    f = np.float32
    luma = _rationals(tags, 529, [0.299, 0.587, 0.114])
    ref = _rationals(tags, 532, [0, 255, 128, 255, 128, 255])
    lr, lg, lb = (f(v) for v in luma)

    def clamp2(v):
        return min(max(v, f(0)), f(2))

    f1 = f(2) - f(2) * lr
    d1 = _fix(clamp2(f1))
    d2 = -_fix(clamp2(lr * f1 / lg))
    f3 = f(2) - f(2) * lb
    d3 = _fix(clamp2(f3))
    d4 = -_fix(clamp2(lb * f3 / lg))

    def code2v(c, rb, rw, cr):
        """Code2V, clamped to +-4096 and truncated to int32."""
        div = f(rw - rb) if f(rw - rb) != 0 else f(1)
        v = (c - np.int64(np.trunc(rb))).astype(np.float32) * f(cr) / div
        return np.trunc(np.clip(v, f(-4096), f(4096))).astype(np.int64)

    x = np.arange(-128, 128)
    cr = code2v(x, f(ref[4] - f(128)), f(ref[5] - f(128)), 127)
    cb = code2v(x, f(ref[2] - f(128)), f(ref[3] - f(128)), 127)
    half = 1 << 15
    cr_r = (d1 * cr + half) >> 16
    cb_b = (d3 * cb + half) >> 16
    cr_g = d2 * cr
    cb_g = d4 * cb + half
    y_tab = code2v(x + 128, ref[0], ref[1], 255)
    yy = y_tab[samples[..., 0]]
    b_, r_ = samples[..., 1], samples[..., 2]
    rgb = np.stack([yy + cr_r[r_], yy + ((cb_g[b_] + cr_g[r_]) >> 16),
                    yy + cb_b[b_]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _cielab_tables():
    """tif_color.c's TIFFCIELabToRGBInit for display_sRGB: the three
    luminance -> value tables of 1501 floats, 255 * (i / 1500) ** (1 /
    2.4) in double, rounded to float."""
    i = np.arange(1501, dtype=np.float64) / 1500
    gamma = 1.0 / float(np.float32(2.4))
    return np.power(i, gamma).astype(np.float32) * np.float32(255)


_SRGB = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                  [0.0556, -0.2040, 1.0570]], np.float32)


def _cielab_rgb(samples: np.ndarray, bps: int, tags: dict) -> np.ndarray:
    """CIELab (L unsigned, a and b signed; 8 or 16 bits) -> RGB by
    libtiff's TIFFCIELab16ToXYZ and TIFFXYZToRGB for display_sRGB, each
    step in float32 in C's order, the white from WhitePoint (D50 without
    the tag)."""
    f = np.float32
    s = samples.astype(np.int64)
    if bps == 8:        # TIFFCIELabToXYZ passes l * 257, a * 256, b * 256
        l_, a_, b_ = s[..., 0] * 257, ((s[..., 1] ^ 128) - 128) * 256, \
            ((s[..., 2] ^ 128) - 128) * 256
    else:
        l_ = s[..., 0]
        a_ = (s[..., 1] ^ 32768) - 32768
        b_ = (s[..., 2] ^ 32768) - 32768
    wp = tags.get(318)
    if wp and len(wp) >= 4:
        white = _rationals(tags, 318, [0, 0])
    else:
        tot = f(f(f(96.4250) + f(100.0)) + f(82.4680))
        white = np.array([f(96.4250) / tot, f(100.0) / tot], np.float32)
    if white[1] == 0:
        raise FormatError("a CIELab image of WhitePoint y 0, which libtiff "
                          "refuses")
    y0 = f(100)
    x0 = f(white[0] / white[1]) * y0
    z0 = f(f(f(1) - white[0]) - white[1]) / white[1] * y0
    L = l_.astype(np.float32) * f(100) / f(65535)
    small = L < f(8.856)
    y_small = L * y0 / f(903.292)
    cby_small = f(7.787) * (y_small / y0) + f(16) / f(116)
    cby_big = (L + f(16)) / f(116)
    y_big = y0 * cby_big * cby_big * cby_big
    Y = np.where(small, y_small, y_big)
    cby = np.where(small, cby_small, cby_big)

    def part(tmp, w0):
        return np.where(tmp < f(0.2069), w0 * (tmp - f(0.13793)) / f(7.787),
                        w0 * tmp * tmp * tmp)

    X = part(a_.astype(np.float32) / f(256) / f(500) + cby, x0)
    Z = part(cby - b_.astype(np.float32) / f(256) / f(200), z0)
    table = _cielab_tables()
    step = f(f(100) - f(1)) / f(1500)
    out = []
    for row in _SRGB:
        v = row[0] * X + row[1] * Y + row[2] * Z
        v = np.minimum(np.maximum(v, f(1)), f(100))
        i = np.minimum(np.trunc((v - f(1)) / step).astype(np.int64), 1500)
        c = np.floor(table[i].astype(np.float64) + 0.5)
        out.append(np.minimum(c, 255))
    return np.stack(out, -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# JPEG 2000

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
# colr's enumerated colour spaces as OpenJPEG names them; any other, an ICC
# profile or no colr box is "unknown", which cv2 reads as sRGB
_ENUMCS = {16: "sRGB", 17: "grey", 18: "sYCC", 24: "e-YCC", 12: "CMYK"}


def _jp2_boxes(data: bytes, pos: int, end: int, top: bool = False):
    """(type, body start, body end) of each box in data[pos:end]; a box
    of length 0 runs to the end, one of length 1 has a 64-bit length.
    With ``top`` (the file's own boxes) the jp2c box runs to the end
    whatever its length says, as OpenJPEG reads it."""
    while pos + 8 <= end:
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise FormatError("the file ends inside a box header")
            length, head = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        elif length == 0:
            length = end - pos
        if top and kind == b"jp2c":
            yield kind, pos + head, end
            return
        if length < head or pos + length > end:
            raise FormatError(f"the {kind!r} box runs past its end")
        yield kind, pos + head, pos + length
        pos += length


def _jp2_header(data: bytes) -> Tuple[dict, int]:
    """The JP2 boxes OpenJPEG reads before the codestream: (the colour
    information of jp2h, where jp2c's contents start)."""
    boxes = _jp2_boxes(data, 0, len(data), top=True)
    if next(boxes, (None,))[0] != b"jP  ":
        raise FormatError("the signature box is not the first")
    if next(boxes, (None,))[0] != b"ftyp":
        raise FormatError("the ftyp box is not the second")
    info = None
    for kind, at, end in boxes:
        if kind == b"jp2h":
            info = _jp2h(data, at, end)
        elif kind == b"jp2c":
            if info is None:
                raise FormatError("no jp2h box before the codestream")
            return info, at
    raise FormatError("no jp2c (codestream) box")


def _jp2h(data: bytes, at: int, end: int) -> dict:
    info = {"enumcs": 0, "pclr": None, "cmap": None, "cdef": None}
    colr = ihdr = False
    for kind, a, e in _jp2_boxes(data, at, end):
        body = data[a:e]
        if kind == b"ihdr" and not ihdr:        # the first one counts
            if len(body) != 14:
                raise FormatError("a bad ihdr box")
            info["ihdr"] = struct.unpack(">IIH", body[:10])
            if not all(info["ihdr"]) or info["ihdr"][2] > 16384:
                raise FormatError(f"an ihdr box of {info['ihdr']}")
            ihdr = True
        elif kind == b"colr" and not colr:      # the first one counts
            colr = True
            if len(body) < 3:
                raise FormatError("a bad colr box")
            if body[0] == 1:
                if len(body) < 7:
                    raise FormatError("a bad colr box")
                info["enumcs"] = struct.unpack(">I", body[3:7])[0]
        elif kind == b"pclr":
            if len(body) < 3:
                raise FormatError("a bad pclr box")
            ne, npc = struct.unpack(">HB", body[:3])
            if not 0 < ne <= 1024 or npc == 0 or len(body) < 3 + npc:
                raise FormatError("a bad pclr box")
            bits = [(b & 0x7F) + 1 for b in body[3:3 + npc]]
            widths = [min((b + 7) >> 3, 4) for b in bits]
            pos, entries = 3 + npc, np.zeros((ne, npc), np.int64)
            if len(body) < pos + ne * sum(widths):
                raise FormatError("the pclr box ends inside its entries")
            for i in range(ne):
                for j, w in enumerate(widths):
                    entries[i, j] = int.from_bytes(body[pos:pos + w], "big")
                    pos += w
            info["pclr"] = (entries, bits)
        elif kind == b"cmap":
            if info["pclr"] is None:
                raise FormatError("a cmap box before the pclr box")
            npc = info["pclr"][0].shape[1]
            if len(body) < 4 * npc:
                raise FormatError("a short cmap box")
            info["cmap"] = [struct.unpack(">HBB", body[4 * i:4 * i + 4])
                            for i in range(npc)]
        elif kind == b"cdef":
            if len(body) < 2:
                raise FormatError("a bad cdef box")
            n = struct.unpack(">H", body[:2])[0]
            if n == 0 or len(body) < 2 + 6 * n:
                raise FormatError("a bad cdef box")
            info["cdef"] = [list(struct.unpack(">HHH",
                                               body[2 + 6 * i:8 + 6 * i]))
                            for i in range(n)]
    if not ihdr:
        raise FormatError("no ihdr box in jp2h")
    return info


def _jp2_check(info: dict, ncomp: int) -> None:
    """OpenJPEG's checks of cdef, pclr and cmap (opj_jp2_check_color)."""
    cmap = info["cmap"]
    if info["cdef"] is not None:
        n = len(cmap) if cmap is not None else ncomp
        for cn, _, asoc in info["cdef"]:
            if cn >= n or (asoc not in (0, 65535) and asoc - 1 >= n):
                raise FormatError("a cdef channel that is not there")
        if any(all(e[0] != c for e in info["cdef"]) for c in range(n)):
            raise FormatError("incomplete channel definitions in cdef")
    if cmap is None:
        return
    npc, used, sane = len(cmap), [False] * len(cmap), True
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        if cmp >= ncomp:
            sane = False
        if mtyp not in (0, 1) or pcol >= npc or (used[pcol] and mtyp == 1) \
                or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
            sane = False
        else:
            used[pcol] = True
    if any(not used[i] and cmap[i][1] != 0 for i in range(npc)):
        sane = False
    if sane and ncomp == 1 and not all(used):   # OpenJPEG's "correction"
        info["cmap"] = [(cmp, 1, i) for i, (cmp, _, _) in enumerate(cmap)]
    if not sane:
        raise FormatError("a bad cmap box")


def read_jp2(data: bytes, decode) -> np.ndarray:
    """JPEG 2000 bytes (a JP2 file or a raw J2K codestream) -> uint8
    [H, W, 3] RGB, as cv2.imread reads them through OpenJPEG 2.5: the
    codestream decoded by the host library (``decode(codestream) ->
    (int32 [ncomp, h, w], largest precision)``, which refuses what cv2
    refuses by the codestream's header), then OpenJPEG's palette (pclr,
    cmap) and channel definitions (cdef), then cv2's conversion: every
    sample shifted right by the largest precision less 8 and cast to 8
    bits; grey (colr 17) repeated, sYCC (18) through cvtColor's integer
    YUV-to-BGR, an unknown colour space read as sRGB.  cv2 refuses 1 or 2
    channels read as sRGB, e-YCC and CMYK; so does this reader.  No EXIF:
    cv2's JPEG 2000 decoder reads none."""
    if data.startswith(JP2_SIGNATURE):
        info, at = _jp2_header(data)
        codestream = data[at:]
    else:
        info, codestream = {"enumcs": 0, "pclr": None, "cmap": None,
                            "cdef": None}, data
    space = _ENUMCS.get(info["enumcs"], "unknown")
    if space in ("e-YCC", "CMYK"):
        raise FormatError(f"the {space} colour space (cv2 refuses it)")
    samples, max_prec = decode(codestream)
    ncomp, h, w = samples.shape
    if "ihdr" in info and info["ihdr"][:2] != (h, w):
        raise FormatError(f"ihdr's size {info['ihdr'][1]}x{info['ihdr'][0]}"
                          f" is not SIZ's {w}x{h}")
    planes = list(samples)
    _jp2_check(info, ncomp)
    if info["pclr"] is not None and info["cmap"] is not None:
        entries, _ = info["pclr"]
        out = []
        for i, (cmp, mtyp, pcol) in enumerate(info["cmap"]):
            src = planes[cmp]
            out.append(src if mtyp == 0 else
                       entries[np.clip(src, 0, len(entries) - 1), pcol])
        planes = out
    if info["cdef"] is not None:                # opj_jp2_apply_cdef's swaps
        cdef = [list(e) for e in info["cdef"]]
        for i, (cn, typ, asoc) in enumerate(cdef):
            if cn >= len(planes) or asoc in (0, 65535):
                continue
            acn = asoc - 1
            if acn >= len(planes) or cn == acn or typ != 0:
                continue
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for e in cdef[i + 1:]:
                if e[0] == cn:
                    e[0] = acn
                elif e[0] == acn:
                    e[0] = cn
    shift = max_prec - 8
    if space == "grey":
        chans = [planes[0]] * 3
    elif len(planes) < 3:
        raise FormatError(f"{len(planes)} channels read as sRGB (cv2 "
                          f"refuses them)")
    else:
        chans = planes[:3]
    rgb = np.stack([(c.astype(np.int64) >> shift) & 0xFF for c in chans], -1)
    if space == "sYCC":
        rgb = _yuv_to_rgb(rgb)
    return np.ascontiguousarray(rgb.astype(np.uint8))


def _yuv_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(COLOR_YUV2BGR) on uint8, its integer path (14-bit
    coefficients, rounded), RGB out."""
    y, u, v = (yuv[..., i].astype(np.int64) for i in range(3))
    u, v = u - 128, v - 128

    def descale(x):
        return (x + (1 << 13)) >> 14

    b = y + descale(u * 33292)
    g = y + descale(u * -6472 + v * -9519)
    r = y + descale(v * 18678)
    return np.clip(np.stack([r, g, b], -1), 0, 255)


# ---------------------------------------------------------------------------
# AVIF: cv2's AvifDecoder over libavif 1.4 (HEIF boxes, then the AV1 item
# through the host library's decoder, then libavif's YUV -> RGB)

AVIF_BRANDS = (b"avif", b"avis")
AVIF_HEAD = 500       # the bytes cv2's AvifDecoder::checkSignature parses


def avif_brand(head: bytes) -> bool:
    """cv2's AVIF signature check: libavif's parse of the file's first
    500 bytes must not fail (running out of bytes is no failure).  Here:
    a leading ftyp box whose major brand or one of whose compatible
    brands is avif or avis (a brand past the 500 bytes passes, as the
    parse runs out first), and no box header cut by the 500 bytes' end
    (the parse fails there)."""
    head = head[:AVIF_HEAD]
    pos = 0
    while pos < len(head):
        if len(head) - pos < 8:
            return False
        size, kind = struct.unpack(">I4s", head[pos:pos + 8])
        at = 8
        if size == 1:
            if len(head) - pos < 16:
                return False
            size, at = struct.unpack(">Q", head[pos + 8:pos + 16])[0], 16
        elif size == 0:
            size = len(head) - pos
        if size < at:
            return False
        if pos == 0:
            if kind != b"ftyp":
                return False
            if size > len(head):
                return True
            if size < at + 8:
                return False
            brands = [head[at:at + 4]] + [
                head[i:i + 4] for i in range(at + 8, size - 3, 4)]
            if not any(b in AVIF_BRANDS for b in brands):
                return False
        if pos + size > len(head):
            return True
        pos += size
    return pos > 0


class _Reader:
    """Big-endian fields of one box's body."""

    def __init__(self, data: bytes, pos: int, end: int, what: str):
        self.data, self.pos, self.end, self.what = data, pos, end, what

    def take(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise FormatError(f"the {self.what} box ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def full(self) -> Tuple[int, int]:
        """A full box's version and flags."""
        return self.uint(1), self.uint(3)


def _avif_meta(data: bytes, pos: int, end: int) -> dict:
    """The meta box's item information as libavif reads it."""
    r = _Reader(data, pos, end, "meta")
    r.full()
    meta = {"hdlr": None, "pitm": None, "iloc": {}, "infe": {}, "iref": [],
            "props": [], "ipma": {}, "idat": None}
    for kind, at, stop in _jp2_boxes(data, r.pos, end):
        b = _Reader(data, at, stop, kind.decode(errors="replace"))
        if kind == b"hdlr":
            b.full()
            b.take(4)
            meta["hdlr"] = b.take(4)
        elif kind == b"pitm":
            version, _ = b.full()
            meta["pitm"] = b.uint(2 if version == 0 else 4)
        elif kind == b"iloc":
            version, _ = b.full()
            if version > 2:
                raise FormatError(f"iloc version {version}")
            sizes = b.uint(2)
            off_size, len_size = sizes >> 12, (sizes >> 8) & 15
            base_size, index_size = (sizes >> 4) & 15, sizes & 15
            for s in (off_size, len_size, base_size) + (
                    (index_size,) if version else ()):
                if s not in (0, 4, 8):
                    raise FormatError(f"an iloc field of {s} bytes")
            for _ in range(b.uint(2 if version < 2 else 4)):
                item = b.uint(2 if version < 2 else 4)
                method = b.uint(2) & 15 if version else 0
                if b.uint(2) != 0:
                    raise FormatError("an item in another file")
                base = b.uint(base_size)
                extents = []
                for _ in range(b.uint(2)):
                    if version and index_size:
                        b.uint(index_size)
                    extents.append((base + b.uint(off_size), b.uint(len_size)))
                if item in meta["iloc"]:
                    raise FormatError(f"item {item} located twice")
                meta["iloc"][item] = (method, extents)
        elif kind == b"iinf":
            version, _ = b.full()
            b.uint(2 if version == 0 else 4)
            for k2, a2, s2 in _jp2_boxes(data, b.pos, stop):
                if k2 != b"infe":
                    continue
                e = _Reader(data, a2, s2, "infe")
                v2, _ = e.full()
                if v2 < 2:
                    continue        # no item type: nothing libavif reads
                item = e.uint(2 if v2 == 2 else 4)
                e.uint(2)
                meta["infe"][item] = e.take(4)      # its type
        elif kind == b"iref":
            version, _ = b.full()
            n = 2 if version == 0 else 4
            for k2, a2, s2 in _jp2_boxes(data, b.pos, stop):
                e = _Reader(data, a2, s2, "iref")
                src = e.uint(n)
                for _ in range(e.uint(2)):
                    meta["iref"].append((k2, src, e.uint(n)))
        elif kind == b"iprp":
            for k2, a2, s2 in _jp2_boxes(data, at, stop):
                if k2 == b"ipco":
                    meta["props"] = [(k3, a3, s3) for k3, a3, s3 in
                                     _jp2_boxes(data, a2, s2)]
                elif k2 == b"ipma":
                    e = _Reader(data, a2, s2, "ipma")
                    version, flags = e.full()
                    for _ in range(e.uint(4)):
                        item = e.uint(2 if version < 1 else 4)
                        assoc = []
                        for _ in range(e.uint(1)):
                            v = e.uint(2 if flags & 1 else 1)
                            bits = 15 if flags & 1 else 7
                            assoc.append((v & ((1 << bits) - 1), v >> bits))
                        meta["ipma"].setdefault(item, []).extend(assoc)
        elif kind == b"idat":
            meta["idat"] = (at, stop)
    return meta


# the properties libavif parses; an essential one it does not know makes
# it drop the item (cv2 then refuses the file)
_AVIF_KNOWN = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap",
               b"irot", b"imir", b"pixi", b"a1op", b"lsel", b"a1lx", b"clli")


def _avif_props(data: bytes, meta: dict, item: int,
                unknown_ok: bool = False) -> dict:
    """The properties associated with an item: kind -> (body start, end),
    the first of each kind; FormatError where libavif refuses them (but
    for an essential property it does not know with ``unknown_ok``)."""
    out = {}
    for index, essential in meta["ipma"].get(item, []):
        if index == 0:
            continue
        if index > len(meta["props"]):
            raise FormatError(f"item {item}'s property {index} is missing")
        kind, at, stop = meta["props"][index - 1]
        if essential and not unknown_ok and (kind not in _AVIF_KNOWN
                                             or kind == b"a1lx"):
            raise FormatError(f"an essential {kind!r} property (cv2 "
                              f"refuses it)")
        if kind == b"colr" and data[at:at + 4] == b"nclx":
            out.setdefault(b"nclx", (at + 4, stop))
        out.setdefault(kind, (at, stop))
    return out


def _avif_layer_props(data: bytes, meta: dict) -> None:
    """libavif's checks of the layer properties as it parses the meta box
    (cv2 then reads no image): each a1op an operating point 0..31, each
    lsel a layer 0..3 or 0xFFFF, each a1lx's reserved bits zero and its
    three sizes present; every a1op and lsel association essential."""
    for kind, at, stop in meta["props"]:
        body = data[at:stop]
        if kind == b"a1op":
            if len(body) < 1:
                raise FormatError("a truncated a1op (cv2 refuses it)")
            if body[0] > 31:
                raise FormatError(f"a1op names operating point {body[0]} "
                                  f"(cv2 refuses it)")
        elif kind == b"lsel":
            if len(body) < 2:
                raise FormatError("a truncated lsel (cv2 refuses it)")
            layer = int.from_bytes(body[:2], "big")
            if layer > 3 and layer != 0xFFFF:
                raise FormatError(f"lsel names layer {layer} (cv2 refuses "
                                  f"it)")
        elif kind == b"a1lx":
            if len(body) < 1 or body[0] >> 1:
                raise FormatError("an a1lx with reserved bits set (cv2 "
                                  "refuses it)")
            if len(body) < 1 + 3 * (4 if body[0] & 1 else 2):
                raise FormatError("a truncated a1lx (cv2 refuses it)")
    for item, assoc in meta["ipma"].items():
        for index, essential in assoc:
            if 0 < index <= len(meta["props"]) and not essential and \
                    meta["props"][index - 1][0] in (b"a1op", b"lsel"):
                kind = meta["props"][index - 1][0].decode()
                raise FormatError(f"item {item}'s {kind} is not essential "
                                  f"(cv2 refuses it)")


def _avif_layers(data: bytes, props: dict, size: int):
    """What libavif asks of libaom for an item of ``size`` bytes: a1op's
    operating point (0 without), lsel's layer (-1 without, or for
    0xFFFF) and the bytes it hands over (a1lx's layers up to lsel's,
    else the whole item); FormatError where libavif refuses them: an
    a1lx layer size not below what is left of the item, an lsel layer
    past a1lx's layers."""
    op = layer = -1
    if b"a1op" in props:
        op = data[props[b"a1op"][0]]
    if b"lsel" in props:
        at = props[b"lsel"][0]
        layer = int.from_bytes(data[at:at + 2], "big")
        if layer == 0xFFFF:
            layer = -1
    sizes = []
    if b"a1lx" in props:
        at = props[b"a1lx"][0]
        n = 4 if data[at] & 1 else 2
        remaining = size
        for i in range(3):
            v = int.from_bytes(data[at + 1 + n * i:at + 1 + n * (i + 1)],
                               "big")
            if not v:
                sizes.append(remaining)
                remaining = 0
                break
            if v >= remaining:
                raise FormatError(f"a1lx's layer {i} does not fit in the "
                                  f"item (cv2 refuses it)")
            sizes.append(v)
            remaining -= v
        if remaining:
            sizes.append(remaining)
    take = size
    if layer >= 0 and sizes:
        if layer >= len(sizes):
            raise FormatError(f"lsel selects layer {layer}, past a1lx's "
                              f"{len(sizes)} (cv2 refuses it)")
        take = sum(sizes[:layer + 1])
    return max(op, 0), layer, take


def _avif_decode_item(data: bytes, meta: dict, item: int, props: dict, av1):
    """An av01 item's planes: its data, with the layer properties as
    libavif hands them to libaom (:func:`_avif_layers`)."""
    stream = _avif_item_data(data, meta, item)
    op, layer, take = _avif_layers(data, props, len(stream))
    return av1(stream[:take], op, layer)


def _avif_item_data(data: bytes, meta: dict, item: int) -> bytes:
    if item not in meta["iloc"]:
        raise FormatError(f"item {item} has no location")
    method, extents = meta["iloc"][item]
    if method == 0:
        base, limit = 0, len(data)
    elif method == 1:
        if meta["idat"] is None:
            raise FormatError("an item in idat without an idat box")
        base, limit = meta["idat"][0], meta["idat"][1]
    else:
        raise FormatError(f"iloc construction method {method}")
    parts = []
    for offset, length in extents:
        start = base + offset
        stop = limit if length == 0 else start + length
        if stop > limit or start > limit:
            raise FormatError(f"item {item}'s data runs past the file")
        parts.append(data[start:stop])
    return b"".join(parts)


def _avif_grid_tiles(data: bytes, meta: dict, item: int) -> list:
    """A grid item's tiles, in its dimg reference's order: (item, its
    properties); FormatError where libavif refuses them (cv2 then reads
    no image): a tile that is not av01, one with an essential property
    libavif does not know, one without av1C or ispe, av1C fields
    (profile, level, tier, depth, monochrome, subsampling, chroma
    position) unlike the first tile's (:func:`_avif_grid`)."""
    tiles = [(dst, _avif_tile_props(data, meta, dst))
             for ref, src, dst in meta["iref"]
             if ref == b"dimg" and src == item]
    if not tiles:
        raise FormatError("a grid without tiles (cv2 refuses it)")
    return tiles


def _avif_tile_props(data: bytes, meta: dict, tile: int) -> dict:
    """A grid tile's properties; FormatError where libavif refuses the
    tile: not av01, an essential property it does not know, no av1C or
    ispe."""
    if meta["infe"].get(tile) != b"av01":
        raise FormatError(f"grid tile {tile} is not an av01 item (cv2 "
                          f"refuses it)")
    props = _avif_props(data, meta, tile)
    for box in (b"av1C", b"ispe"):
        if box not in props:
            raise FormatError(f"grid tile {tile} has no {box.decode()} "
                              f"(cv2 refuses it)")
    return props


def _avif_grid_layout(data: bytes, meta: dict, item: int) -> tuple:
    """A grid item's ImageGrid body (version 0; flag bit 0 for 32-bit
    output sizes): (rows, columns, output width, output height)."""
    grid = _avif_item_data(data, meta, item)
    body = _Reader(grid, 0, len(grid), "grid")
    version, flags = body.uint(1), body.uint(1)
    if version != 0:
        raise FormatError(f"an ImageGrid of version {version} (cv2 refuses "
                          f"it)")
    rows, cols = body.uint(1) + 1, body.uint(1) + 1
    n = 4 if flags & 1 else 2
    out_w, out_h = body.uint(n), body.uint(n)
    if body.pos != body.end or not out_w or not out_h:
        raise FormatError("a malformed ImageGrid (cv2 refuses it)")
    check_size(out_w, out_h)
    return rows, cols, out_w, out_h


def _avif_grid(data: bytes, meta: dict, tiles: list, layout: tuple, av1):
    """A grid's planes as libavif assembles them: the layout's (rows,
    columns, output width, height; :func:`_avif_grid_layout`) tiles of
    one size, checked as libavif checks them (MIAF's: tiles of at least
    64x64, even sizes where chroma is subsampled; the output covered,
    and each last row and column inside it), each tile decoded by
    ``av1`` and copied in, the whole cropped to the output size."""
    rows, cols, out_w, out_h = layout
    fields = [data[a + 1:a + 3] for a, _ in (p[b"av1C"] for _, p in tiles)]
    if any(f != fields[0] for f in fields):
        raise FormatError("grid tiles whose av1C differ (cv2 refuses them)")
    if len(tiles) != rows * cols:
        raise FormatError(f"a {rows}x{cols} grid of {len(tiles)} tiles (cv2 "
                          f"refuses it)")
    decoded = []
    for t, props in tiles:
        ispe = _Reader(data, *props[b"ispe"], "ispe")
        ispe.full()
        size = ispe.uint(4), ispe.uint(4)
        decoded.append(_avif_decode_item(data, meta, t, props, av1))
        if decoded[-1][0][0].shape[::-1] != size:
            # libavif scales the frame to the tile's ispe: a deliberate
            # difference, as for a single item
            raise FormatError(f"grid tile {t}'s ispe {size[0]}x{size[1]} is "
                              f"not its AV1 frame's "
                              f"{decoded[-1][0][0].shape[1]}x"
                              f"{decoded[-1][0][0].shape[0]}")
    planes0, info0 = decoded[0]
    th, tw = planes0[0].shape
    keys = ("subsampling", "bit_depth", "full_range", "matrix", "primaries",
            "transfer")
    for planes, info in decoded[1:]:
        if planes[0].shape != (th, tw) or len(planes) != len(planes0) or any(
                info[k] != info0[k] for k in keys):
            raise FormatError("grid tiles that differ in size or colour "
                              "(cv2 refuses them)")
    sx, sy = info0["subsampling"]
    mono = len(planes0) == 1
    if tw < 64 or th < 64 or (not mono and (
            (sx and (out_w % 2 or tw % 2)) or (sy and (out_h % 2 or th % 2)))):
        raise FormatError(f"grid tiles of {tw}x{th} for a {out_w}x{out_h} "
                          f"image, which MIAF forbids (cv2 refuses them)")
    if tw * cols < out_w or th * rows < out_h or tw * (cols - 1) >= out_w \
            or th * (rows - 1) >= out_h:
        raise FormatError(f"{rows}x{cols} tiles of {tw}x{th} do not fit a "
                          f"{out_w}x{out_h} image (cv2 refuses them)")
    out = []
    for p in range(len(planes0)):
        px, py = (sx, sy) if p else (0, 0)
        plane = np.empty(((out_h + py) >> py, (out_w + px) >> px), np.uint16)
        for i, (planes, _) in enumerate(decoded):
            y0, x0 = (i // cols) * th >> py, (i % cols) * tw >> px
            part = planes[p][:plane.shape[0] - y0, :plane.shape[1] - x0]
            plane[y0:y0 + part.shape[0], x0:x0 + part.shape[1]] = part
        out.append(plane)
    return out, info0


_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
               b"urn:mpeg:hevc:2015:auxid:1")


def _avif_alpha_item(data: bytes, meta: dict, item: int):
    """The colour item's alpha as libavif finds it (avifDecoderDataFind-
    AlphaItem): (the first item, in iloc's order, with data whose last
    auxl reference names the colour item and whose auxC names alpha,
    skipping those with an essential property libavif does not know;
    None) or, for a grid whose every tile has such an alpha item, (None,
    those items in the tiles' iloc order: libavif's alpha grid, laid
    out as the colour grid); (None, None) without alpha.  FormatError
    where a tile has two alpha items or its alpha item is itself a grid
    tile (libavif's invalid grid)."""
    aux = {}
    for ref, src, dst in meta["iref"]:
        if ref == b"auxl":
            aux[src] = dst

    def is_alpha(cand, strict):
        if strict:
            try:
                props = _avif_props(data, meta, cand)
            except FormatError:
                return False
        else:
            props = _avif_props(data, meta, cand, unknown_ok=True)
        if b"auxC" not in props:
            return False
        at, stop = props[b"auxC"]
        return data[at + 4:stop].split(b"\0", 1)[0] in _ALPHA_URNS

    for cand, (_, extents) in meta["iloc"].items():
        if aux.get(cand) == item and sum(n for _, n in extents) and \
                is_alpha(cand, True):
            return cand, None
    if meta["infe"].get(item) != b"grid":
        return None, None
    # libavif's items in their order (iloc's, then the others), each
    # tile's grid the last dimg naming it
    order = list(meta["iloc"]) + [i for i in meta["infe"]
                                  if i not in meta["iloc"]]
    grid_of = {dst: src for ref, src, dst in meta["iref"] if ref == b"dimg"}
    alphas = []
    for tile in order:
        if grid_of.get(tile) != item:
            continue
        found = [a for a in order
                 if aux.get(a) == tile and is_alpha(a, False)]
        if len(found) > 1 or (found and found[0] in grid_of):
            raise FormatError("a grid tile whose alpha items libavif "
                              "refuses (cv2 refuses it)")
        if not found:
            return None, None
        alphas.append(found[0])
    return None, alphas or None


def _limited_to_full(a: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifLimitedToFullY: limited-range alpha to full range
    in C's integer division (truncating towards zero), clamped."""
    lo, hi = 16 << (depth - 8), 235 << (depth - 8)
    top = (1 << depth) - 1
    num = (a.astype(np.int64) - lo) * top + (hi - lo) // 2
    q = np.abs(num) // (hi - lo) * np.sign(num)
    return np.clip(q, 0, top)


def _avif_alpha(planes, info, alpha, prem: bool) -> np.ndarray:
    """The decoded alpha (planes, info) as libavif hands it on with the
    colour planes: FormatError where cv2 refuses the pair (a grey image
    with alpha, alpha of another bit depth); limited-range alpha made
    full range.  Alpha of another size selects libavif's route only
    (cv2's colours are then the alpha route's whatever its values);
    premultiplied, the port refuses it by name."""
    a_planes, a_info = alpha
    if len(planes) == 1:
        raise FormatError("a grey image with alpha (cv2 refuses it)")
    if a_info["bit_depth"] != info["bit_depth"]:
        raise FormatError(f"{a_info['bit_depth']}-bit alpha on a "
                          f"{info['bit_depth']}-bit image (cv2 refuses it)")
    a = a_planes[0]
    if a.shape != planes[0].shape:
        if prem:
            raise FormatError("premultiplied alpha of another size than "
                              "the image, which the port does not read")
        return np.zeros(planes[0].shape, np.int64)
    if not a_info["full_range"]:
        return _limited_to_full(a, info["bit_depth"])
    return a.astype(np.int64)


def _avif_convert(data: bytes, props: dict, planes, info, alpha=None,
                  prem: bool = False) -> np.ndarray:
    """Planes to RGB by the colr box's nclx values (else the sequence
    header's), with the alpha libavif hands on (:func:`_avif_alpha`)."""
    if b"nclx" in props:
        c = _Reader(data, *props[b"nclx"], "colr")
        primaries, _, matrix, full = (c.uint(2), c.uint(2), c.uint(2),
                                      c.uint(1) >> 7)
    else:
        primaries, matrix, full = (info["primaries"], info["matrix"],
                                   info["full_range"])
    a = None if alpha is None else _avif_alpha(planes, info, alpha, prem)
    return _avif_rgb(planes, info["subsampling"], matrix, bool(full),
                     primaries, info["bit_depth"], a, prem)


# sample entries are VisualSampleEntry boxes: 78 bytes before their own
_VISUAL_SAMPLE_ENTRY = 78


def _avif_tracks(data: bytes, pos: int, end: int) -> list:
    """The trak boxes of a moov box as libavif reads them: per track its
    tkhd id and size (width and height >> 16), the tref auxl and prem
    track (the first id of the last of each), and the sample table:
    chunk offsets (stco and co64, appended), stsc's (first chunk,
    samples per chunk), stsz's sizes (or one size for all) and the
    sample entries (type, their boxes after the VisualSampleEntry's
    fields).  The handler is not read: libavif takes any.  FormatError
    where libavif refuses the boxes."""
    tracks = []
    for kind, at, stop in _jp2_boxes(data, pos, end):
        if kind != b"trak":
            continue
        t = {"id": 0, "size": None, "aux_for": 0, "prem_by": 0,
             "stbl": None}
        edts = False
        for k2, a2, s2 in _jp2_boxes(data, at, stop):
            if k2 == b"tkhd":
                if t["size"] is not None:
                    raise FormatError("a track with two tkhd boxes")
                r = _Reader(data, a2, s2, "tkhd")
                version, _ = r.full()
                if version > 1:
                    raise FormatError(f"a tkhd box of version {version}")
                r.take(16 if version else 8)
                t["id"] = r.uint(4)
                r.take(4 + (8 if version else 4) + 52)
                t["size"] = r.uint(4) >> 16, r.uint(4) >> 16
                if not all(t["size"]):
                    raise FormatError(f"a track of size {t['size'][0]}x"
                                      f"{t['size'][1]} (cv2 refuses it)")
            elif k2 == b"tref":
                for k3, a3, s3 in _jp2_boxes(data, a2, s2):
                    if k3 in (b"auxl", b"prem"):
                        key = "aux_for" if k3 == b"auxl" else "prem_by"
                        t[key] = _Reader(data, a3, s3, "tref").uint(4)
            elif k2 == b"mdia":
                for k3, a3, s3 in _jp2_boxes(data, a2, s2):
                    if k3 == b"minf":
                        _avif_minf(data, a3, s3, t)
            elif k2 == b"edts":
                if edts:
                    raise FormatError("a track with two edts boxes (cv2 "
                                      "refuses it)")
                edts = True
                _avif_edit_list(data, a2, s2)
        if t["size"] is None:
            raise FormatError("a track without tkhd (cv2 refuses it)")
        tracks.append(t)
    if not tracks:
        raise FormatError("a moov box without tracks (cv2 refuses it)")
    return tracks


def _avif_edit_list(data: bytes, pos: int, end: int) -> None:
    """libavif's checks of an edts box (its edit list only sets the
    repetition; the first frame is the first sample whatever the media
    time): one elst; a repeating one (flag 1) of version 0 or 1 with one
    entry whose segment duration is not 0."""
    lists = [(at, stop) for kind, at, stop in _jp2_boxes(data, pos, end)
             if kind == b"elst"]
    if len(lists) != 1:
        raise FormatError(f"an edts box with {len(lists)} elst boxes (cv2 "
                          f"refuses it)")
    r = _Reader(data, *lists[0], "elst")
    version, flags = r.full()
    if not flags & 1:
        return
    if r.uint(4) != 1 or version > 1 or not r.uint(8 if version else 4):
        raise FormatError("a repeating edit list that is not one entry of "
                          "version 0 or 1 with a duration (cv2 refuses it)")


def _avif_minf(data: bytes, pos: int, end: int, t: dict) -> None:
    """A minf box's sample table into the track ``t``."""
    for kind, at, stop in _jp2_boxes(data, pos, end):
        if kind == b"stbl":
            if t["stbl"] is not None:
                raise FormatError("a track with two stbl boxes")
            t["stbl"] = _avif_sample_table(data, at, stop)


def _avif_sample_table(data: bytes, pos: int, end: int) -> dict:
    stbl = {"chunks": [], "stsc": [], "sizes": [], "size": 0,
            "entries": []}
    for kind, at, stop in _jp2_boxes(data, pos, end):
        r = _Reader(data, at, stop, kind.decode(errors="replace"))
        if kind in (b"stco", b"co64"):
            r.full()
            n = 8 if kind == b"co64" else 4
            stbl["chunks"] += [r.uint(n) for _ in range(r.uint(4))]
        elif kind == b"stsc":
            r.full()
            for _ in range(r.uint(4)):
                first, per = r.uint(4), r.uint(4)
                r.uint(4)                       # sample description index
                prev = stbl["stsc"][-1][0] if stbl["stsc"] else 0
                if first <= prev or (not prev and first != 1):
                    raise FormatError("an stsc box whose chunks do not rise "
                                      "from 1 (cv2 refuses it)")
                stbl["stsc"].append((first, per))
        elif kind == b"stsz":
            r.full()
            stbl["size"], count = r.uint(4), r.uint(4)
            if not stbl["size"]:
                stbl["sizes"] = [r.uint(4) for _ in range(count)]
        elif kind == b"stsd":
            if r.full()[0] != 0:
                raise FormatError("an stsd box of a version other than 0")
            count = r.uint(4)
            for k2, a2, s2 in _jp2_boxes(data, r.pos, stop):
                if len(stbl["entries"]) == count:
                    break
                props = []
                if k2 == b"av01":
                    if s2 - a2 < _VISUAL_SAMPLE_ENTRY:
                        raise FormatError("an av01 sample entry that ends "
                                          "early (cv2 refuses it)")
                    props = list(_jp2_boxes(data, a2 + _VISUAL_SAMPLE_ENTRY,
                                            s2))
                stbl["entries"].append((k2, props))
            if len(stbl["entries"]) < count:
                raise FormatError("an stsd box that ends early")
    return stbl


def _avif_first_sample(data: bytes, stbl: dict) -> bytes:
    """A track's first sample after libavif's check of the whole table
    (avifCodecDecodeInputFillFromSampleTable): every chunk holds samples
    (its stsc entry's count), every sample has a size and lies inside
    the file."""
    first, k = None, 0
    for c, offset in enumerate(stbl["chunks"]):
        per = next((n for f, n in reversed(stbl["stsc"]) if f <= c + 1), 0)
        if not per:
            raise FormatError("a chunk of no samples (cv2 refuses it)")
        for _ in range(per):
            if stbl["size"]:
                size = stbl["size"]
            elif k < len(stbl["sizes"]):
                size = stbl["sizes"][k]
            else:
                raise FormatError("a sample table that ends early (cv2 "
                                  "refuses it)")
            if offset + size > len(data):
                raise FormatError("a sample past the end of the file (cv2 "
                                  "refuses it)")
            if first is None:
                first = data[offset:offset + size]
            offset += size
            k += 1
    return first


def _avif_entry_props(data: bytes, entries) -> dict:
    """The first av01 sample entry's boxes as item properties: kind ->
    (body start, end), the first of each kind, colr's nclx apart."""
    for kind, boxes in entries:
        if kind == b"av01":
            out = {}
            for k, at, stop in boxes:
                if k == b"colr" and data[at:at + 4] == b"nclx":
                    out.setdefault(b"nclx", (at + 4, stop))
                out.setdefault(k, (at, stop))
            return out
    return {}


def _avif_sequence(data: bytes, tracks: list, av1) -> np.ndarray:
    """The first frame of an image sequence as libavif picks it: the
    colour track is the first with a sample table of chunks, an av01
    sample entry, and no auxl reference; its first sample decoded, its
    av1C and colr from the sample entry; the alpha track the first such
    track whose auxl names the colour track, premultiplied where the
    colour track's prem names it."""
    def usable(t):
        return t["stbl"] is not None and t["id"] and t["stbl"]["chunks"] \
            and any(k == b"av01" for k, _ in t["stbl"]["entries"])

    colour = next((t for t in tracks if usable(t) and not t["aux_for"]),
                  None)
    if colour is None:
        raise FormatError("an image sequence without an AV1 colour track "
                          "(cv2 refuses it)")
    props = _avif_entry_props(data, colour["stbl"]["entries"])
    if b"av1C" not in props:
        raise FormatError("an AV1 track without av1C (cv2 refuses it)")
    check_size(*colour["size"])
    alpha_track = next((t for t in tracks if usable(t) and t["aux_for"] ==
                        colour["id"]), None)
    planes, info = av1(_avif_first_sample(data, colour["stbl"]))
    if planes[0].shape[::-1] != colour["size"]:
        raise FormatError(f"the track's {colour['size'][0]}x"
                          f"{colour['size'][1]} is not its first frame's "
                          f"{planes[0].shape[1]}x{planes[0].shape[0]}")
    alpha, prem = None, False
    if alpha_track is not None:
        alpha = av1(_avif_first_sample(data, alpha_track["stbl"]))
        prem = colour["prem_by"] == alpha_track["id"]
    return _avif_convert(data, props, planes, info, alpha, prem)


def read_avif(data: bytes, av1) -> np.ndarray:
    """AVIF bytes -> uint8 [H, W, 3] RGB, as cv2.imread reads them through
    libavif: the primary av01 item's AV1 stream (or an image sequence's
    first frame) decoded by the host library (``av1(stream,
    operating_point, layer) -> (planes, info)``: the Y, U, V planes of the
    frame libaom hands libavif, as uint16 at the stream's bit depth, 8,
    10 or 12, their subsampling and the sequence header's depth and
    colour fields), then libavif's conversion to 8-bit RGB by the colr
    box's nclx values (else the sequence header's).  iloc versions 0-2
    with every field size, items in the file or in idat, several
    extents; infe versions 2 and 3; ipma's 7- and 15-bit indices.
    Layered items as libavif reads them (:func:`_avif_layers`): a1op's
    operating point, lsel's layer (its first shown frame of all the
    layers), a1lx's layer sizes cutting the item under an lsel; a1op
    and lsel must be essential, and are refused as libavif refuses them
    (:func:`_avif_layer_props`).  Ignored as cv2 ignores them: irot,
    imir, clap, an ICC colr, EXIF, the hidden flag.  An alpha item (auxl, auxC alpha) is decoded as
    libavif decodes it: cv2's BGRA conversion picks libavif's route, and
    a prem reference from the colour item to it has the colours
    un-premultiplied (:func:`_avif_rgb`).  Refused as cv2 refuses them:
    an essential property libavif does not know, pixi depths that are
    not av1C's, alpha on a grey image or of another bit depth.  A grid
    primary item is assembled from its av01 tiles as libavif does
    (:func:`_avif_grid`), then converted as a whole (the chroma
    upsampling reads across the tiles' seams); its own ispe, colr and
    pixi apply; alpha items on each of its tiles make libavif's alpha
    grid (:func:`_avif_alpha_item`), premultiplied where the colour
    grid's prem reference names that new item.  libavif reads the tracks
    of an avis major brand, or of a moov box under a major brand that is
    neither (:func:`_avif_sequence`: the first sample of the colour
    track, an auxl track its alpha).
    Refused, naming themselves: an ispe that is not the AV1 frame's (or
    the grid's output) size, a track size that is not its first
    frame's, premultiplied alpha of another size than the image."""
    boxes = _jp2_boxes(data, 0, len(data))
    first = next(boxes, None)
    if first is None or first[0] != b"ftyp":
        raise FormatError("the ftyp box is not the first")
    at, stop = first[1], first[2]
    brands = [data[i:i + 4] for i in [at] + list(range(at + 8, stop - 3, 4))]
    if stop - at < 8 or not any(b in AVIF_BRANDS for b in brands):
        raise FormatError("the ftyp box names neither avif nor avis")
    major = brands[0]
    meta = tracks = None
    for kind, at, stop in boxes:
        if kind == b"meta":
            if meta is not None:
                raise FormatError("a second meta box")
            meta = _avif_meta(data, at, stop)
        elif kind == b"moov":
            if tracks is not None:
                raise FormatError("a second moov box")
            tracks = _avif_tracks(data, at, stop)
    if meta is not None:
        _avif_layer_props(data, meta)
    # libavif needs a meta box under an avif brand, a moov under avis
    if b"avis" in brands and tracks is None:
        raise FormatError("an avis brand without a moov box (cv2 refuses "
                          "it)")
    if meta is None and b"avif" in brands:
        raise FormatError("no meta box")
    # it reads the tracks of an avis major brand, or of a moov box under
    # a major brand that is neither
    if major == b"avis" or (tracks and major != b"avif"):
        return _avif_sequence(data, tracks, av1)
    if meta is None:
        raise FormatError("no meta box")
    if meta["hdlr"] != b"pict":
        raise FormatError(f"the meta handler is {meta['hdlr']!r}, not pict")
    item = meta["pitm"]
    if item is None or item not in meta["infe"]:
        raise FormatError("no primary item")
    kind = meta["infe"][item]
    if kind not in (b"av01", b"grid"):
        raise FormatError(f"a primary item of type {kind!r}")
    props = _avif_props(data, meta, item)
    if b"ispe" not in props:
        raise FormatError("the primary item has no ispe")
    ispe = _Reader(data, *props[b"ispe"], "ispe")
    ispe.full()
    size = ispe.uint(4), ispe.uint(4)
    check_size(*size)
    tiles = _avif_grid_tiles(data, meta, item) if kind == b"grid" else None
    # a grid takes its first tile's av1C (libavif copies it to the grid)
    config = props if b"av1C" in props or tiles is None else tiles[0][1]
    if b"av1C" not in config:
        raise FormatError("the primary item has no av1C")
    at, stop = config[b"av1C"]
    if stop - at < 4 or data[at] != 0x81:
        raise FormatError("a malformed av1C")
    depth = 12 if data[at + 2] & 0x20 else 10 if data[at + 2] & 0x40 else 8
    if b"pixi" in props:
        pixi = _Reader(data, *props[b"pixi"], "pixi")
        pixi.full()
        depths = pixi.take(pixi.uint(1))
        if any(d != depth for d in depths):
            raise FormatError(f"pixi's depths {list(depths)} are not "
                              f"av1C's {depth} (cv2 refuses them)")
    # libavif hands libaom the item's data alone: a sequence header among
    # av1C's config OBUs only does not make a file cv2 reads
    if tiles is None:
        planes, info = _avif_decode_item(data, meta, item, props, av1)
    else:
        layout = _avif_grid_layout(data, meta, item)
        planes, info = _avif_grid(data, meta, tiles, layout, av1)
    if planes[0].shape[::-1] != size:       # cv2 refuses it for a grid
        raise FormatError(f"ispe's {size[0]}x{size[1]} is not the "
                          f"{'grid' if tiles else 'AV1 frame'}'s "
                          f"{planes[0].shape[1]}x{planes[0].shape[0]}")
    alpha_item, tile_alphas = _avif_alpha_item(data, meta, item)
    # the colour item's last prem reference names its alpha item
    prem_by = [dst for ref, src, dst in meta["iref"]
               if ref == b"prem" and src == item]
    alpha, prem = None, False
    if tile_alphas is not None:
        # libavif's alpha grid: a new item (the largest id of the items
        # it made, from iloc, iinf, a reference's source or a dimg's
        # tile, + 1) of the colour grid's layout over the tiles' alphas
        alpha = _avif_grid(data, meta, [
            (a, _avif_tile_props(data, meta, a)) for a in tile_alphas],
            layout, av1)
        ids = set(meta["iloc"]) | set(meta["infe"]) | {
            i for ref, src, dst in meta["iref"]
            for i in ((src, dst) if ref == b"dimg" else (src,))}
        prem = bool(prem_by) and prem_by[-1] == max(ids) + 1
    elif alpha_item is not None:
        a_kind = meta["infe"].get(alpha_item)
        if a_kind == b"av01":
            alpha = _avif_decode_item(data, meta, alpha_item,
                                      _avif_props(data, meta, alpha_item),
                                      av1)
        elif a_kind == b"grid":
            alpha = _avif_grid(data, meta, _avif_grid_tiles(
                data, meta, alpha_item), _avif_grid_layout(
                    data, meta, alpha_item), av1)
        else:
            raise FormatError(f"an alpha item of type {a_kind!r} (cv2 "
                              f"refuses it)")
        prem = bool(prem_by) and prem_by[-1] == alpha_item
    return _avif_convert(data, props, planes, info, alpha, prem)


# libyuv's YuvConstants as libavif picks them (avif's getLibYUVConstants):
# (UB, UG, VG, VR, YG, YB) by (full range, matrix coefficients)
_LIBYUV_601 = {False: (128, 25, 52, 102, 18997, -1160),
               True: (113, 22, 46, 90, 16320, 32)}
_LIBYUV = {1: {False: (128, 14, 34, 115, 18997, -1160),
               True: (119, 12, 30, 101, 16320, 32)},
           2: _LIBYUV_601, 5: _LIBYUV_601, 6: _LIBYUV_601,
           9: {False: (128, 12, 42, 107, 19003, -1160),
               True: (120, 11, 37, 94, 16320, 32)}}
# matrix 12 (chromaticity-derived) by the colour primaries
_LIBYUV_DERIVED = {1: _LIBYUV[1], 2: _LIBYUV[1], 5: _LIBYUV_601,
                   6: _LIBYUV_601, 9: _LIBYUV[9]}


def _neighbours(c: np.ndarray):
    """Each chroma sample and the one to its right (the last repeated)."""
    c = np.concatenate([c, c[:, -1:]], 1)
    return c[:, :-1], c[:, 1:]


def _up_row(c: np.ndarray, w: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any: each row of ``c`` to width w
    (output j = 2k + 1 weighs sample k 3:1 against k + 1, j = 2k + 2 the
    other way; the first and last outputs copy their samples)."""
    a, b = _neighbours(c)
    out = np.empty((c.shape[0], 2 * c.shape[1] + 1), np.int32)
    out[:, 0] = c[:, 0]
    out[:, 1::2] = (3 * a + b + 2) >> 2
    out[:, 2::2] = (a + 3 * b + 2) >> 2
    out = out[:, :w]
    out[:, w - 1] = c[:, (w - 1) // 2]
    return out


def _up_rows(s: np.ndarray, t: np.ndarray, w: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Bilinear_Any: the output rows nearer chroma
    rows ``s`` (weighted 3:1 against ``t``), width w."""
    sa, sb = _neighbours(s)
    ta, tb = _neighbours(t)
    out = np.empty((s.shape[0], 2 * s.shape[1] + 1), np.int32)
    out[:, 1::2] = (9 * sa + 3 * sb + 3 * ta + tb + 8) >> 4
    out[:, 2::2] = (3 * sa + 9 * sb + ta + 3 * tb + 8) >> 4
    out = out[:, :w]
    m = (w - 1) // 2
    out[:, 0] = (3 * s[:, 0] + t[:, 0] + 2) >> 2
    out[:, w - 1] = (3 * s[:, m] + t[:, m] + 2) >> 2
    return out


def _upsample(c: np.ndarray, h: int, w: int, sub_y: bool) -> np.ndarray:
    """A chroma plane at the luma size as libyuv's I420 / I422
    ToARGBMatrixFilter upsamples it with kFilterBilinear."""
    c = c.astype(np.int32)
    if not sub_y:
        return _up_row(c, w)
    out = np.empty((h, w), np.int32)
    out[0] = _up_row(c[:1], w)[0]
    pairs = (h - 1) // 2                 # output rows 1..2 * pairs
    if pairs:
        s, t = c[:pairs], c[1:pairs + 1]
        out[1:2 * pairs:2] = _up_rows(s, t, w)
        out[2:2 * pairs + 1:2] = _up_rows(t, s, w)
    if h % 2 == 0:
        out[h - 1] = _up_row(c[h // 2 - 1:h // 2], w)[0]
    return out


def _avif_rgb(planes, subsampling, matrix: int, full: bool, primaries: int,
              depth: int = 8, alpha=None, premultiplied: bool = False
              ) -> np.ndarray:
    """Y, U, V planes of 8, 10 or 12 bits and their (x, y) subsampling ->
    uint8 RGB as libavif 1.4 converts them for cv2 (8-bit BGR, or BGRA
    where the file has an alpha item: ``alpha`` its full-range plane at
    ``depth``, which above 8 bits changes libavif's route).

    A grey (4:0:0) image is its Y plane, as cv2 copies it (above 8 bits
    cv2's convertTo by 2^-(depth-8): rounded, ties to even).  The
    matrices libyuv has constants for (1, 2, 5, 6, 9, and 12 under
    primaries 1, 2, 5, 6, 9) by libyuv's fixed-point YuvPixel after its
    bilinear chroma upsampling (:func:`_libyuv_rgb`): 8-bit planes as
    they are; above 8 bits cut to 8 by libyuv's Convert16To8Plane (a
    shift that truncates), except where libyuv converts them to BGRA
    itself: 10-bit planes with alpha (I010 / I210 / I410AlphaToARGB) and
    12-bit 4:2:0 ones (I012ToARGB, nearest chroma).  The others cv2
    reads (0 at 4:4:4, 4, 7, 8 in full range, 12 under other primaries,
    15) by libavif's float path at the planes' depth
    (:func:`_avif_rgb_float`).  ``premultiplied`` alpha (a prem
    reference) is undone as libavif does for an unpremultiplied BGRA
    output: libyuv's ARGBUnattenuate on 8-bit BGRA (:func:`_unattenuate`)
    after libyuv and after libavif's fast float paths, in float inside
    its slow one."""
    y = planes[0].astype(np.int32)
    h, w = y.shape
    if len(planes) == 1:
        if alpha is not None:
            raise FormatError("a grey image with alpha (cv2 refuses it)")
        if depth > 8:
            y = np.minimum(np.rint(y / (1 << (depth - 8))), 255)
        return np.repeat(y.astype(np.uint8)[..., None], 3, -1)
    u, v = planes[1].astype(np.int32), planes[2].astype(np.int32)
    sub_x, sub_y = subsampling
    constants = (_LIBYUV_DERIVED.get(primaries) if matrix == 12
                 else _LIBYUV.get(matrix))
    if constants is None:
        if matrix not in _FLOAT_MATRICES:
            raise FormatError(f"matrix coefficients {matrix} (cv2 refuses "
                              f"them)")
        if matrix == 0 and sub_x:
            raise FormatError("the identity matrix with subsampled chroma "
                              "(cv2 refuses it)")
        # libavif's fast paths (no chroma to upsample, YUV coefficients or
        # 8-bit full-range identity) leave the alpha to libyuv afterwards
        fast = not sub_x and matrix != 8 and (matrix != 0 or (
            depth == 8 and full))
        inside = alpha if premultiplied and not fast else None
        rgb = _avif_rgb_float(y, u, v, sub_x, sub_y, matrix, full,
                              primaries, depth, inside)
        if premultiplied and fast:
            rgb = _unattenuate(rgb, _alpha8(alpha, depth))
        return rgb
    nearest = False
    if depth > 8 and (alpha is None or (depth == 12 and not sub_y)):
        y, u, v = (p >> (depth - 8) for p in (y, u, v))
        a8 = None if alpha is None else alpha >> (depth - 8)
        depth = 8
    elif depth == 12:                   # 4:2:0: I012ToARGBMatrix
        a8, nearest = _alpha8(alpha, depth), True
    else:
        a8 = None if alpha is None else alpha >> (depth - 8)
    rgb = _libyuv_rgb(y, u, v, subsampling, constants[full], depth,
                      nearest)
    if premultiplied:
        rgb = _unattenuate(rgb, a8)
    return rgb


def _libyuv_rgb(y, u, v, subsampling, constants, depth: int,
                nearest: bool = False) -> np.ndarray:
    """libyuv's YuvPixel (8 bits), YuvPixel10 or YuvPixel12 over planes of
    that depth: the luma replicated to 16 bits, the chroma (upsampled
    bilinearly at its own depth, or nearest) cut to 8 bits, the fixed
    point constants (UB, UG, VG, VR, YG, YB), each channel >> 6 and
    clamped."""
    h, w = y.shape
    sub_x, sub_y = subsampling
    if sub_x and nearest:
        u, v = (c.repeat(1 + sub_y, 0).repeat(2, 1)[:h, :w] for c in (u, v))
    elif sub_x:
        u, v = _upsample(u, h, w, sub_y), _upsample(v, h, w, sub_y)
    y = y.astype(np.int64)
    if depth == 8:
        y32 = y * 0x0101
    else:
        s = depth - 8
        y32 = (y << (16 - depth)) | (y >> (2 * depth - 16))
        u, v = np.minimum(u >> s, 255), np.minimum(v >> s, 255)
    ub, ug, vg, vr, yg, yb = constants
    ui, vi = u.astype(np.int64) - 128, v.astype(np.int64) - 128
    y1 = ((y32 * yg) >> 16) + yb
    rgb = np.empty((h, w, 3), np.uint8)
    for i, c in enumerate((y1 + vi * vr, y1 - (ui * ug + vi * vg),
                           y1 + ui * ub)):
        rgb[..., i] = np.clip(c >> 6, 0, 255)
    return rgb


def _alpha8(alpha: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifReformatAlpha to 8 bits: a copy at 8 bits, else
    (int)(0.5f + a / max * 255) in float32."""
    if depth == 8:
        return alpha.astype(np.int64)
    f32 = np.float32
    a = alpha.astype(f32) / f32((1 << depth) - 1)
    return (f32(0.5) + a * f32(255)).astype(np.int64)


# libyuv's fixed_invtbl8: 0x01000000 + 0x10000 / a, a's 1 / a in 8.8
_INV_ALPHA = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)]
                      + [0x100], np.int64)


def _unattenuate(rgb: np.ndarray, alpha8: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuate as its SSE2 / AVX2 rows compute it (cv2's
    libavif on an x86-64 host): (c * 257 * inv[a]) >> 16 in unsigned 16
    bits, packed with signed saturation (results of 32768 and above, at
    alpha 1, become 0)."""
    v = (rgb.astype(np.int64) * 257 * _INV_ALPHA[alpha8][..., None]) >> 16
    return np.where(v >= 32768, 0, np.minimum(v, 255)).astype(np.uint8)


# libavif's (kr, kb) for the matrices libyuv has no constants for;
# anything else falls back to BT.601's
_KR_KB = {4: (0.30, 0.11), 7: (0.212, 0.087)}
_FLOAT_MATRICES = (0, 4, 7, 8, 12, 15)
# libavif's colour primaries (rx, ry, gx, gy, bx, by, wx, wy), for matrix
# 12's coefficients; values it does not know are BT.709's
_PRIMARIES = {
    4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290)}
_BT709 = (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290)


def _derived_kr_kb(primaries: int):
    """libavif's avifColorPrimariesComputeYCoeffs, in float32."""
    rx, ry, gx, gy, bx, by, wx, wy = (
        np.float32(c) for c in _PRIMARIES.get(primaries, _BT709))
    one = np.float32(1)
    rz, gz, bz, wz = (one - (rx + ry), one - (gx + gy), one - (bx + by),
                      one - (wx + wy))
    den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz)
                + bx * (ry * gz - gy * rz))
    kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz)
                + wz * (gx * by - bx * gy))) / den
    kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz)
                + wz * (rx * gy - gx * ry))) / den
    return kr, kb


def _chroma_float(c, table, h: int, w: int, sub_x: bool, sub_y: bool):
    """A chroma plane as libavif's own float path takes it at each luma
    position: its sample, or for subsampled chroma its bilinear filter
    (9:3:3:1 over the sample, its neighbour across the nearer column and
    row, and the diagonal; none past the image's first or last sample)."""
    t = table[c]
    if not sub_x:
        return t
    def near(n, sub):
        i = np.arange(n)
        adj = np.where(i % 2 == 1, 1, -1)
        adj[(i == 0) | ((i == n - 1) & (i % 2 == 1))] = 0
        if not sub:
            adj[:] = 0
        return i >> int(sub), (i >> int(sub)) + adj
    ci, cn = near(w, True)
    rj, rn = near(h, sub_y)
    f32 = np.float32
    return (((t[rj][:, ci] * f32(9 / 16) + t[rj][:, cn] * f32(3 / 16))
             + t[rn][:, ci] * f32(3 / 16)) + t[rn][:, cn] * f32(1 / 16))


def _avif_rgb_float(y, u, v, sub_x: bool, sub_y: bool, matrix: int,
                    full: bool, primaries: int, depth: int = 8,
                    alpha=None) -> np.ndarray:
    """Planes of the bit depth through libavif's own float32 conversion
    (avifImageYUV8ToRGB8Color / YUV16ToRGB8Color,
    avifImageYUVAnyToRGBAnySlow with its bilinear chroma, the identity and
    YCgCo modes): each level over the depth's range; ``alpha`` (at the
    same depth) premultiplied and undone in float as the slow path does
    (0 where alpha is 0, RGB / A capped at 1 below full alpha)."""
    f32 = np.float32
    if matrix == 8 and not full:
        raise FormatError("YCgCo in limited range (cv2 refuses it)")
    top, s = (1 << depth) - 1, depth - 8
    if full:
        by, ry, buv, ruv = 0, top, 128 << s, top
    else:
        by, ry, buv, ruv = 16 << s, 219 << s, 128 << s, 224 << s
    if matrix == 0:
        buv, ruv = by, ry
    levels = np.arange(1 << depth, dtype=f32)
    Y = ((levels - f32(by)) / f32(ry))[y]
    table = (levels - f32(buv)) / f32(ruv)
    h, w = y.shape
    Cb = _chroma_float(u, table, h, w, sub_x, sub_y)
    Cr = _chroma_float(v, table, h, w, sub_x, sub_y)
    if matrix == 0:
        R, G, B = Cr, Y, Cb
    elif matrix == 8:
        t = Y - Cb
        R, G, B = t + Cr, Y + Cb, t - Cr
    else:
        if matrix == 12:
            kr, kb = _derived_kr_kb(primaries)
        else:
            kr, kb = (f32(c) for c in _KR_KB.get(matrix, (0.299, 0.114)))
        one, two = f32(1), f32(2)
        kg = one - kr - kb
        R = Y + (two * (one - kr)) * Cr
        B = Y + (two * (one - kb)) * Cb
        G = Y - ((two * ((kr * (one - kr) * Cr) + (kb * (one - kb) * Cb)))
                 / kg)
    rgb = np.stack([R, G, B], -1).astype(f32)
    rgb = np.clip(rgb, f32(0), f32(1))
    if alpha is not None:
        a = (alpha.astype(f32) / f32((1 << depth) - 1))[..., None]
        safe = np.where(a == 0, f32(1), a)
        rgb = np.where(a == 0, f32(0),
                       np.where(a < 1, np.minimum(rgb / safe, f32(1)), rgb))
    return (f32(0.5) + rgb * f32(255)).astype(np.uint8)


# ---------------------------------------------------------------------------
# GIF

def _gif_sub_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The data of the sub-blocks at ``pos`` and the position after their
    terminator."""
    parts = []
    while True:
        if pos >= len(data):
            raise FormatError("the file ends inside a block")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        if pos + n > len(data):
            raise FormatError("the file ends inside a block")
        parts.append(data[pos:pos + n])
        pos += n


def _gif_walk(data: bytes, pos: int) -> None:
    """cv2's first pass over the blocks, to the trailer: extensions and
    images skipped by their lengths; any other byte fails, as does a file
    that ends before the trailer."""
    while True:
        if pos >= len(data):
            raise FormatError("the file ends before the trailer")
        kind = data[pos]
        if kind == 0x3B:
            return
        if kind == 0x21:
            _, pos = _gif_sub_blocks(data, pos + 2)
        elif kind == 0x2C:
            if pos + 10 > len(data):
                raise FormatError("the file ends inside an image descriptor")
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0) + 1
            _, pos = _gif_sub_blocks(data, pos)
        else:
            raise FormatError(f"a block of type {kind:#04x}")


# cv2's colours for a GIF with neither table: grey i, but white for 1
_GIF_DEFAULT_TABLE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
_GIF_DEFAULT_TABLE[1] = 255


def read_gif(data: bytes, lzw) -> np.ndarray:
    """GIF bytes -> uint8 [H, W, 3] RGB, the first frame, as cv2 5's own
    GifDecoder reads it: the signature GIF87a or GIF89a, a logical screen
    of at least 1x1, a background index inside the global colour table
    when there is one, and blocks that run to the trailer; then the
    extensions before the first image (the last graphic control
    extension's transparency index counts; its disposal does not change
    the first frame), and the image, which must lie inside the screen.
    The canvas is the global table's background colour, or black without
    a global table; the frame's pixels are drawn over it at its offset
    (de-interlaced), each from the local table, else the global one when
    the index is past the local table, and a transparent index leaves the
    canvas; with neither table, index i is grey i but 1 is white.  The
    host library's ``lzw(data, min_code_size, npix) ->
    (indices, count)`` decodes the codes; fewer than the frame's pixels
    fail.  No EXIF: cv2 reads none from a GIF."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise FormatError("no GIF87a or GIF89a signature")
    if len(data) < 13:
        raise FormatError("the file ends inside the screen descriptor")
    sw, sh, flags, bg = struct.unpack("<HHBB", data[6:12])
    if not sw or not sh:
        raise FormatError(f"a logical screen of {sw}x{sh}")
    check_size(sw, sh)
    pos, gtable = 13, None
    if flags & 0x80:
        n = 1 << ((flags & 7) + 1)
        if pos + 3 * n > len(data):
            raise FormatError("the file ends inside the global colour table")
        gtable = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
        if bg >= n:
            raise FormatError(f"background index {bg} past the global "
                              f"colour table")
    _gif_walk(data, pos)
    transparent = None
    while data[pos] == 0x21:                    # the extensions
        label = data[pos + 1]
        if label == 0xF9:
            if data[pos + 2] != 4:
                raise FormatError("a graphic control extension not of 4 "
                                  "bytes")
            transparent = data[pos + 6] if data[pos + 3] & 1 else None
        _, pos = _gif_sub_blocks(data, pos + 2)
    if data[pos] != 0x2C:
        raise FormatError("no image before the trailer")
    left, top, w, h, iflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
    if not w or not h or left + w > sw or top + h > sh:
        raise FormatError(f"a {w}x{h} frame at ({left}, {top}) outside the "
                          f"{sw}x{sh} screen")
    pos += 10
    ltable = gtable
    if iflags & 0x80:
        n = 1 << ((iflags & 7) + 1)
        ltable = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    if ltable is None:
        ltable = _GIF_DEFAULT_TABLE
    mcs = data[pos]
    if not 2 <= mcs <= 11:
        raise FormatError(f"an LZW minimum code size of {mcs}")
    codes, _ = _gif_sub_blocks(data, pos + 1)
    index, count = lzw(codes, mcs, w * h)
    if count < w * h:
        raise FormatError(f"the LZW data hold {count} of the frame's "
                          f"{w * h} pixels")
    index = index.reshape(h, w)
    if iflags & 0x40:                           # the four interlace passes
        rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                               np.arange(2, h, 4), np.arange(1, h, 2)])
        index = index[np.argsort(rows)]
    colours = np.zeros((256, 3), np.uint8)
    known = np.zeros(256, bool)
    if gtable is not None:
        colours[:len(gtable)], known[:len(gtable)] = gtable, True
    colours[:len(ltable)], known[:len(ltable)] = ltable, True
    opaque = np.ones((h, w), bool) if transparent is None \
        else index != transparent
    if not known[index[opaque]].all():
        raise FormatError("a colour index past the colour tables")
    canvas = np.zeros((sh, sw, 3), np.uint8)
    if gtable is not None:
        canvas[:] = gtable[bg]
    frame = canvas[top:top + h, left:left + w]
    frame[opaque] = colours[index[opaque]]
    return canvas


# ---------------------------------------------------------------------------
# PNM (P1-P6), PAM (P7) and PFM (PF): cv2's PxMDecoder, PAMDecoder and
# PFMDecoder

class _Bytes:
    """cv2's RLByteStream over the file: reading past the end fails."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise FormatError("the file ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FormatError("the file ends inside the image data")
        self.pos += n
        return self.data[self.pos - n:self.pos]


_SPACE = b" \t\n\v\f\r"


def _pnm_number(s: _Bytes, maxdigits: int = 0) -> int:
    """cv2's ReadNumber: whitespace and # comments (to the line's end)
    before the digits, one byte past them consumed."""
    code = s.byte()
    while not 0x30 <= code <= 0x39:
        if code == 0x23:                        # '#'
            while code not in (10, 13):
                code = s.byte()
            code = s.byte()
        elif code in _SPACE:
            while code in _SPACE:
                code = s.byte()
        else:
            raise FormatError(f"an unexpected byte {code:#04x} in a number")
    val = digits = 0
    while True:
        val = val * 10 + code - 0x30
        if val > 0x7FFFFFFF:
            raise FormatError("a number too large")
        digits += 1
        if maxdigits and digits >= maxdigits:
            break
        code = s.byte()
        if not 0x30 <= code <= 0x39:
            break
    return val


def _bits_to_rgb(rows: np.ndarray, w: int, one_black: bool) -> np.ndarray:
    """Rows of MSB-first bits -> grey RGB: 1 black and 0 white, or the
    reverse."""
    bits = np.unpackbits(rows, axis=1)[:, :w]
    grey = (bits ^ 1 if one_black else bits) * np.uint8(255)
    return np.repeat(grey[..., None], 3, -1)


def read_pnm(data: bytes) -> np.ndarray:
    """P1-P6 bytes -> uint8 [H, W, 3] RGB as cv2's PxMDecoder reads them:
    P1 and P4 bits with 1 black; ASCII samples clamped to maxval and
    scaled to 0..255 by integer division (above maxval 255 kept and their
    high byte taken); binary 8-bit samples as they are, whatever maxval;
    16-bit samples (maxval above 255) big-endian, their high byte."""
    if len(data) < 2 or data[:1] != b"P" or data[1:2] not in b"123456":
        raise FormatError("not a P1-P6 header")
    kind = data[1] - 0x30
    s = _Bytes(data, 2)
    w, h = _pnm_number(s), _pnm_number(s)
    maxval = 1 if kind in (1, 4) else _pnm_number(s)
    if maxval > 65535 or not (w > 0 and h > 0 and maxval > 0):
        raise FormatError(f"a {w}x{h} image of maxval {maxval}")
    check_size(w, h)
    channels = 3 if kind in (3, 6) else 1
    if kind == 1:
        bits = np.array([[_pnm_number(s, 1) != 0 for _ in range(w)]
                         for _ in range(h)], np.uint8)
        return _bits_to_rgb(np.packbits(bits, axis=1), w, True)
    if kind == 4:
        rows = np.frombuffer(s.take(h * ((w + 7) // 8)), np.uint8)
        return _bits_to_rgb(rows.reshape(h, -1), w, True)
    n = h * w * channels
    if kind in (2, 3):
        v = np.minimum(np.array([_pnm_number(s) for _ in range(n)],
                                np.int64), maxval)
        v = v >> 8 if maxval > 255 else v * 255 // maxval
    elif maxval > 255:
        v = np.frombuffer(s.take(2 * n), ">u2") >> 8
    else:
        v = np.frombuffer(s.take(n), np.uint8)
    v = v.astype(np.uint8).reshape(h, w, channels)
    return np.ascontiguousarray(np.repeat(v, 3 // channels, -1))


def _pam_line(s: _Bytes):
    """cv2's ReadPAMHeaderLine: (field, value), field None for a blank
    line or a comment."""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    if code == 0x23:
        while code not in (10, 13):
            code = s.byte()
        return None, ""
    if code in (10, 13):
        return None, ""
    ident = bytearray()
    while len(ident) < 8 and code not in _SPACE:
        ident.append(code)
        code = s.byte()
    if code not in _SPACE:
        raise FormatError("a bad PAM header line")
    name = ident.decode("latin-1")
    if name not in ("ENDHDR", "HEIGHT", "WIDTH", "DEPTH", "MAXVAL",
                    "TUPLTYPE"):
        raise FormatError(f"an unknown PAM header field {name!r}")
    if code in (10, 13):
        return name, ""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    value = bytearray()
    while len(value) < 255 and code not in (10, 13):
        value.append(code)
        code = s.byte()
    return name, value.decode("latin-1")


def _pam_int(value: str) -> int:
    """cv2's ParseInt: digits between optional whitespace."""
    digits = value.strip(" \t\n\v\f\r")
    if not digits.isdigit() or not digits.isascii():
        raise FormatError(f"a bad PAM number {value!r}")
    return int(digits)


# TUPLTYPE -> the DEPTH cv2 requires of it
_PAM_TUPLTYPES = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2,
                  "RGB": 3, "RGB_ALPHA": 4}


def read_pam(data: bytes) -> np.ndarray:
    """P7 bytes -> uint8 [H, W, 3] RGB as cv2's PAMDecoder reads them for
    a colour image: WIDTH, HEIGHT, DEPTH (1-4) and MAXVAL once each,
    ENDHDR; 16-bit samples (MAXVAL above 255) big-endian, their high
    byte; 8-bit samples as they are.  Three channels are copied as they
    stand into cv2's BGR image (so RGB comes out reversed); one or two
    give grey, four RGB without alpha; MAXVAL 1 reads the bytes as packed
    bits, 1 white.  A TUPLTYPE must have its DEPTH.  cv2 converts only
    the first ceil(WIDTH / DEPTH) pixels of a GRAYSCALE_ALPHA or RGB_ALPHA
    row and leaves the rest of its image uninitialised; this reader gives
    every pixel its grey or RGB value."""
    if data[:3] not in (b"P7\n", b"P7\r"):
        raise FormatError("not a P7 header")
    s = _Bytes(data, 3)
    fields = {}
    tupltype = ""
    while True:
        name, value = _pam_line(s)
        if name is None:
            continue
        if name == "ENDHDR":
            break
        if name == "TUPLTYPE":
            tupltype = value.rstrip(" \t\n\v\f\r")
            if tupltype not in _PAM_TUPLTYPES:
                raise FormatError(f"an unknown TUPLTYPE {value!r}")
            continue
        if name in fields:
            raise FormatError(f"{name} twice")
        fields[name] = _pam_int(value)
        if name == "MAXVAL" and fields[name] > 65535:
            raise FormatError(f"MAXVAL {fields[name]}")
    if len(fields) < 4:
        raise FormatError("a PAM header without WIDTH, HEIGHT, DEPTH and "
                          "MAXVAL")
    w, h, depth, maxval = (fields[k] for k in ("WIDTH", "HEIGHT", "DEPTH",
                                               "MAXVAL"))
    if not tupltype:
        if depth == 1 and maxval == 1:
            tupltype = "BLACKANDWHITE"
        elif depth in (1, 3) and maxval < 256:
            tupltype = "GRAYSCALE" if depth == 1 else "RGB"
        else:
            raise FormatError(f"no TUPLTYPE for DEPTH {depth}, MAXVAL "
                              f"{maxval}")
    if not 1 <= depth <= 4 or _PAM_TUPLTYPES[tupltype] != depth:
        raise FormatError(f"DEPTH {depth} for TUPLTYPE {tupltype}")
    check_size(w, h)
    wide = maxval > 255
    row = w * depth * (2 if wide else 1)
    raw = np.frombuffer(s.take(h * row), np.uint8).reshape(h, row)
    if maxval == 1:                             # cv2's "bit mode"
        return _bits_to_rgb(raw[:, :(w + 7) // 8], w, False)
    v = (raw.view(">u2") >> 8).astype(np.uint8) if wide else raw
    v = v.reshape(h, w, depth)
    if depth == 3:
        return v[..., ::-1].copy()
    if depth == 4:
        return v[..., :3].copy()
    return np.repeat(v[..., :1], 3, -1)


def read_pfm(data: bytes) -> np.ndarray:
    """PF bytes -> uint8 [H, W, 3] RGB as cv2's PFMDecoder reads them:
    width, height and scale each ended by one whitespace byte; float32
    rows bottom-up, little-endian when the scale is negative; every
    sample divided by |scale| and rounded to 0..255 (half to even; NaN,
    infinities and values past int32 give 0, as cvRound's do).  A
    grey PFM (Pf), which cv2 returns as one channel, is refused."""
    if data[:2] == b"Pf":
        raise FormatError("a grey PFM (cv2 fails on it for a colour read)")
    if data[:3] != b"PF\n":
        raise FormatError("not a PF header")
    s = _Bytes(data, 3)

    def token() -> str:
        out = bytearray()
        for _ in range(2048):
            c = s.byte()
            if c >= 128:
                raise FormatError("a non-ASCII byte in the header")
            if c in _SPACE:
                break
            out.append(c)
        return out.decode()

    w, h, scale = _c_atoi(token()), _c_atoi(token()), _c_atof(token())
    check_size(w, h)
    if not abs(scale) > 0:
        raise FormatError(f"a scale of {scale}")
    v = np.frombuffer(s.take(h * w * 12), "<f4" if scale < 0 else ">f4")
    v = v.reshape(h, w, 3)[::-1].astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        return _round_u8(v * np.float32(1.0 / abs(scale)))


def _c_atoi(text: str) -> int:
    """C's atoi: leading whitespace, a sign and digits; 0 for none."""
    m = re.match(r"\s*([+-]?\d+)", text)
    return int(m.group(1)) if m else 0


def _c_atof(text: str) -> float:
    """C's atof: the longest prefix strtod reads (decimal, hexadecimal,
    inf, nan), 0 for none."""
    m = re.match(r"\s*([+-]?)(0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|"
                 r"\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?|infinity|inf|nan|"
                 r"(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)", text,
                 re.IGNORECASE)
    if not m:
        return 0.0
    body = m.group(2)
    value = float.fromhex(body) if body[:2].lower() == "0x" else float(body)
    return -value if m.group(1) == "-" else value


# ---------------------------------------------------------------------------
# Sun raster: cv2's SunRasterDecoder

def read_sun(data: bytes) -> np.ndarray:
    """Sun raster bytes -> uint8 [H, W, 3] RGB as cv2's SunRasterDecoder
    reads them: RT_OLD and RT_STANDARD (cv2 refuses RT_BYTE_ENCODED and
    RT_FORMAT_RGB: its header check tests the image type where it means
    the encoding); depths 1 and 8 through an RMT_EQUAL_RGB colour map of
    at most 3 << depth bytes (missing entries black) or the grey ramp,
    24 bits as BGR, 32 as XBGR; rows padded to 16 bits."""
    if len(data) < 32:
        raise FormatError("the file ends inside the header")
    _, w, h, bpp, _, kind, maptype, maplength = struct.unpack(">8i",
                                                              data[:32])
    pal_size = 3 << bpp if 0 < bpp <= 8 else 0
    if not (w > 0 and h > 0 and bpp in (1, 8, 24, 32) and kind in (0, 1)
            and ((maptype == 0 and maplength == 0)
                 or (maptype == 1 and 0 < maplength <= pal_size))):
        raise FormatError(f"a {w}x{h} {bpp}-bit raster of type {kind}, map "
                          f"type {maptype} of {maplength} bytes")
    check_size(w, h)
    s = _Bytes(data, 32)
    if maplength:
        cmap = np.frombuffer(s.take(maplength), np.uint8)
        n = maplength // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = cmap[:3 * n].reshape(3, n).T
    elif bpp <= 8:
        palette = np.repeat((np.arange(1 << bpp) * 255 // ((1 << bpp) - 1)
                             ).astype(np.uint8)[:, None], 3, 1)
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    rows = np.frombuffer(s.take(h * pitch), np.uint8).reshape(h, pitch)
    if bpp == 1:
        return palette[np.unpackbits(rows, axis=1)[:, :w]]
    if bpp == 8:
        return palette[rows[:, :w]]
    if bpp == 24:
        return rows[:, :3 * w].reshape(h, w, 3)[..., ::-1].copy()
    return rows[:, :4 * w].reshape(h, w, 4)[..., :0:-1].copy()


# ---------------------------------------------------------------------------
# Radiance HDR: cv2's HdrDecoder over its copy of Bruce Walter's rgbe.c

def _hdr_lines(data: bytes, pos: int):
    """fgets with a 128-byte buffer: (line, position after it)."""
    end = data.find(b"\n", pos, pos + 127)
    end = min(len(data), pos + 127) if end < 0 else end + 1
    if end == pos:
        raise FormatError("the file ends inside the header")
    return data[pos:end], end


def read_hdr(data: bytes) -> np.ndarray:
    """Radiance HDR bytes -> uint8 [H, W, 3] RGB as cv2's HdrDecoder reads
    them: header lines to the first blank line, one of them exactly
    ``FORMAT=32-bit_rle_rgbe``, then ``-Y <height> +X <width>`` (cv2 reads
    no other orientation, nor an XYZE file); scanlines of 8 to 32767
    pixels in the new run-length form while they start with 2, 2 (the
    rest of the image flat from the first that does not), narrower images
    flat; each
    pixel's mantissas times 2 ** (exponent - 136) in float, times 255,
    rounded as cv2's convertTo rounds."""
    pos, found = 0, False
    while True:                                 # to the first blank line
        line, pos = _hdr_lines(data, pos)
        if line[:1] == b"\0":
            raise FormatError("a header line that starts with NUL")
        if line == b"\n":
            break
        found |= line == b"FORMAT=32-bit_rle_rgbe\n"
    if not found:
        raise FormatError("no FORMAT=32-bit_rle_rgbe line")
    line, pos = _hdr_lines(data, pos)
    m = re.match(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)", line)
    if not m:
        raise FormatError(f"a resolution line other than -Y h +X w: "
                          f"{line[:40]!r}")
    h, w = int(m.group(1)), int(m.group(2))
    check_size(w, h)
    rgbe = np.empty((h * w, 4), np.uint8)
    done = 0
    if 8 <= w <= 0x7FFF:
        while done < h * w:
            if pos + 4 > len(data):
                raise FormatError("the file ends inside a scanline")
            head = data[pos:pos + 4]
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                break
            if head[2] << 8 | head[3] != w:
                raise FormatError("a scanline of the wrong width")
            pos += 4
            line = bytearray()
            for c in range(4):
                end = (c + 1) * w
                while len(line) < end:
                    if pos + 2 > len(data):
                        raise FormatError("the file ends inside a scanline")
                    n = data[pos]
                    count = n - 128 if n > 128 else n
                    if count == 0 or count > end - len(line):
                        raise FormatError("bad scanline data")
                    if n > 128:                 # a run
                        line += data[pos + 1:pos + 2] * count
                        pos += 2
                    else:                       # count bytes as they are
                        if pos + 1 + count > len(data):
                            raise FormatError("the file ends inside a "
                                              "scanline")
                        line += data[pos + 1:pos + 1 + count]
                        pos += 1 + count
            rgbe[done:done + w] = np.frombuffer(bytes(line),
                                                np.uint8).reshape(4, w).T
            done += w
    rest = h * w - done
    if rest:
        if pos + 4 * rest > len(data):
            raise FormatError("the file ends inside the pixels")
        rgbe[done:] = np.frombuffer(data[pos:pos + 4 * rest],
                                    np.uint8).reshape(rest, 4)
    e = rgbe[:, 3].astype(np.int64)
    f = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    with np.errstate(over="ignore"):
        v = rgbe[:, :3].astype(np.float32) * f[:, None] * np.float32(255)
    return _round_u8(v).reshape(h, w, 3)


def _round_u8(v: np.ndarray) -> np.ndarray:
    """float32 -> uint8 as cv2's convertTo rounds: half to even, 0..255,
    and 0 for NaN, infinities and values past int32 (cvRound's
    INT_MIN)."""
    r = np.rint(v).astype(np.float64)
    r[~((r >= -2.0 ** 31) & (r < 2.0 ** 31))] = 0
    return np.clip(r, 0, 255).astype(np.uint8)
