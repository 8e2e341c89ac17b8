"""PNG, BMP, WebP and TIFF files read as ``cv2.imread(path,
IMREAD_COLOR)`` reads them, and the signatures that pick a reader.

``cv2.imread`` picks its decoder by the file's first bytes, not by its
name: a PNG named ``.jpg`` is read as a PNG.  :func:`sniff` names the
format the same way; ``native.decode_image`` reads JPEG with the port's
decoder and PNG, BMP, WebP and TIFF here (with the host library's inner
loops), and refuses the other formats cv2 reads, naming them.

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
strips and tiles, Deflate and libtiff's sample rules here; LZW and
PackBits in the host library (``csrc/tiff_decode.cc``).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# what cv2.imread reads but the port does not: (name, test on the head)
_OTHERS = (
    ("WebP", lambda h: h[:4] == b"RIFF" and h[8:12] == b"WEBP"),
    ("TIFF", lambda h: h[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00",
                                 b"MM\x00+")),
    ("JPEG 2000", lambda h: h[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
     or h[:4] == b"\xff\x4f\xff\x51"),
    ("AVIF", lambda h: h[4:8] == b"ftyp" and h[8:12] in (b"avif", b"avis")),
    ("OpenEXR", lambda h: h[:4] == b"\x76\x2f\x31\x01"),
    ("PNM", lambda h: len(h) > 1 and h[:1] == b"P" and h[1:2] in
     b"1234567Ff"),
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
    """A PNG or BMP file cv2 would not read either; the caller names it."""


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
                 34676: "SGI LogLuv", 34677: "SGI LogL", 32809: "ThunderScan",
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


def read_tiff(data: bytes, lzw, packbits) -> np.ndarray:
    """TIFF bytes (classic or BigTIFF, either byte order) -> uint8 [H, W,
    3] RGB, as cv2.imread reads the first page: through libtiff's RGBA
    interface (TIFFReadRGBAStrip / Tile), which cv2 asks for whenever its
    output is 8-bit.  That interface takes grey (MINISBLACK, MINISWHITE
    inverted) at 1, 8 and 16 bits (16-bit grey by its high byte; grey in
    tiles whose right part is clipped as libtiff's grey routines misstep
    over it), planar grey and RGB at 8 and 16 bits (16-bit samples become
    (v + 128) // 257) with alpha (associated: kept; unassociated:
    multiplied into the colour, as libtiff's UaToAa table rounds it; a
    fourth RGB sample without an ExtraSamples tag, or an unspecified one
    past 3 samples, counts as associated), and palettes of 1, 4 and 8 bits
    (a colour map with any entry above 255 is read by its high byte); cv2
    refuses 2- and 4-bit grey.  Strips or tiles, chunky or
    planar, compressions none, LZW (the host library's ``lzw``),
    Deflate (zlib) and PackBits (``packbits``); predictor 2 (horizontal
    differencing, 8 and 16 bits) only where libtiff's codec honours it
    (LZW and Deflate), FillOrder 2 uncompressed (each byte's bits
    reversed).  The
    Orientation tag: 2 and 3 flip each strip or tile left to right (the
    RGBA reader's flip), 3 and 4 then flip the image upside down (cv2's);
    cv2 fails on 5 to 8 (a turned image of another shape), and so does
    this reader.  Other kinds raise :class:`FormatError`
    naming themselves."""
    tags, e = _tiff_ifd(data)

    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    w, h = one(256), one(257)
    if not w or not h:
        raise FormatError("no ImageWidth or ImageLength")
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
    if compression not in (1, 5, 8, 32946, 32773):
        raise FormatError(f"{kind}, which the port does not read")
    if photometric not in (0, 1, 2, 3):
        raise FormatError(f"{kind}, which the port does not read")
    # cv2 takes 1, 8 and 16 bits, and 4 in a palette
    if len(set(bits)) != 1 or bps not in ((1, 4, 8) if photometric == 3
                                          else (1, 8, 16)) or \
            sample_format not in (1,) or planar not in (1, 2):
        raise FormatError(f"{kind} of sample format {sample_format}, planar "
                          f"configuration {planar}, which the port does not "
                          f"read")
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
    if fill_order == 2 and compression != 1:
        raise FormatError(f"{kind} with FillOrder 2, which the port does "
                          f"not read")
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
    row_bytes = (tw * chunk_spp * bps + 7) // 8
    dtype = np.dtype(e + "u2") if bps == 16 else np.dtype(np.uint8)
    planes = np.zeros((nplanes, h, w, chunk_spp),
                      np.uint16 if bps == 16 else np.uint8)
    for p in range(nplanes):
        for k in range(across * down):
            ty, tx = divmod(k, across)
            rows = th if tiled else min(th, h - ty * th)
            size = row_bytes * rows
            i = p * across * down + k
            raw = data[offsets[i]:offsets[i] + counts[i]]
            if fill_order == 2:                 # libtiff reverses the bits
                raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            if compression == 1:
                if len(raw) < size:
                    raise FormatError("the file ends inside a strip or tile")
                buf = raw[:size]
            elif compression == 5:
                buf = lzw(raw, size)
            elif compression == 32773:
                buf = packbits(raw, size)
            else:
                try:
                    buf = zlib.decompressobj().decompress(raw, size)
                except zlib.error as err:
                    raise FormatError(f"Deflate: {err}") from None
                if len(buf) < size:
                    raise FormatError("Deflate data end before the strip "
                                      "is full")
            if bps >= 8:
                s = np.frombuffer(buf, dtype).reshape(rows, tw, chunk_spp)
                if predictor == 2:
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
