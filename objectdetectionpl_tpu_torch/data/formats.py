"""PNG and BMP files read as ``cv2.imread(path, IMREAD_COLOR)`` reads
them, and the signatures that pick a reader.

``cv2.imread`` picks its decoder by the file's first bytes, not by its
name: a PNG named ``.jpg`` is read as a PNG.  :func:`sniff` names the
format the same way; ``native.decode_image`` reads JPEG with the port's
decoder and PNG and BMP here, and refuses the other formats cv2 reads,
naming them.

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
    ("TIFF", lambda h: h[:4] in (b"II*\x00", b"MM\x00*")),
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
