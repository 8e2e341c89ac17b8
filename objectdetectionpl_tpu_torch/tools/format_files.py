"""Image files of every kind the port's reader takes, written from the
committed fixtures, for ``chip_smoke.py formats`` and the CPU tests.

    write_format_files(directory) -> {kind: path}

The kinds (``KINDS``): a baseline JPEG; the CMYK fixture and the committed
YCCK and arithmetic-coded (sequential, progressive) fixtures, which the
system libjpeg wrote; a JPEG cut at half its bytes, a progressive one cut
in its sixth scan (libjpeg smooths its blocks) and one with bit flips in
its scan data; PNGs (RGB 8-bit, grey 16-bit Adam7, a 4-bit palette with
tRNS, and an RGB PNG named ``.jpg``); BMPs (24-bit, RLE8).  Every file is
made the same way on every machine, so the SHA-256 of each one's decode
(``data/testdata/formats/sha256.json``, cv2's decodes, which
``tests/test_torch_port_image_formats.py`` holds against cv2 and the
port) checks the port's reader wherever it runs.

``png_bytes``, ``chunk`` and ``bmp_bytes`` are the writers: PNG of any colour type,
bit depth and interlace, each row with a filter of its own (None, Sub,
Up, Average, Paeth in turn); BMP of BI_RGB, BI_BITFIELDS or RLE rows.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict

import numpy as np

from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.formats import PNG_SIGNATURE
from objectdetectionpl_tpu_torch.tools.fixture_trees import (TESTDATA,
                                                            UNSUPPORTED)

FORMATS = TESTDATA / "formats"     # the fixtures only libjpeg's encoder
HASHES = FORMATS / "sha256.json"   # wrote, and cv2's decodes of every kind
BASE = "voc_420_q75_500x375.jpg"
RESTART = "restart7_420_q90_333x251.jpg"
PROGRESSIVE = "progressive_420_q75_160x120.jpg"   # cut in its 6th scan
KINDS = ("jpeg", "jpeg_cmyk", "jpeg_ycck", "jpeg_arithmetic",
         "jpeg_arithmetic_progressive", "jpeg_cut", "jpeg_progressive_cut",
         "jpeg_damaged", "png",
         "png_gray16_adam7", "png_palette4", "png_named_jpg", "bmp",
         "bmp_rle8")
COMMITTED = {"jpeg": TESTDATA / BASE,
             "jpeg_cmyk": TESTDATA / UNSUPPORTED[0],
             "jpeg_ycck": FORMATS / "ycck_420_q85_160x120.jpg",
             "jpeg_arithmetic": FORMATS / "arith_420_q80_160x120.jpg",
             "jpeg_arithmetic_progressive":
                 FORMATS / "arith_progressive_420_q80_160x120.jpg"}


def chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_rows(rows, bpp):
    """Raw rows (bytes) -> the filtered stream, filter k % 5 on row k."""
    out, prev = bytearray(), bytes(len(rows[0])) if rows else b""
    for k, row in enumerate(rows):
        f = k % 5
        enc = bytearray()
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            enc.append((x - pred) & 0xFF)
        out += bytes([f]) + enc
        prev = row
    return bytes(out)


def pack(samples, depth: int) -> bytes:
    """A row of samples (ints) at ``depth`` bits -> bytes (big-endian,
    the last byte padded with zero bits)."""
    samples = np.asarray(samples, np.int64).reshape(-1)
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    bits = ((samples[:, None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(-1).astype(np.uint8)).tobytes()


def png_bytes(samples, color: int, depth: int, interlace: int = 0,
              palette=None, trns=None, before: bytes = b"",
              after: bytes = b"", idat=None) -> bytes:
    """samples [H, W, channels] -> a PNG; ``before`` / ``after`` are chunks
    placed before / after the IDAT, ``idat`` replaces the image data."""
    samples = np.asarray(samples)
    h, w, nch = samples.shape
    bpp = max(1, nch * depth // 8)
    stream = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            stream += _filter_rows([pack(r, depth) for r in sub], bpp)
    data = PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", bytes(palette))
    if trns is not None:
        data += chunk(b"tRNS", trns)
    data += before + chunk(b"IDAT", zlib.compress(
        stream if idat is None else idat)) + after
    return data + chunk(b"IEND", b"")


def bmp_bytes(w: int, h: int, bpp: int, pixels: bytes, compression=0,
              palette=b"", masks=b"", clrused=0, top_down=False,
              os2=False) -> bytes:
    """A BMP of ``pixels`` (rows as stored, padded) with a 40-byte info
    header (or the OS/2 12-byte one), then masks and palette."""
    if os2:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                           bpp, compression, len(pixels), 2835, 2835,
                           clrused, 0)
    offset = 14 + len(info) + len(masks) + len(palette)
    head = struct.pack("<2sIHHI", b"BM", offset + len(pixels), 0, 0, offset)
    return head + info + masks + palette + pixels


def bmp_rows(rows, bits_per_pixel: int) -> bytes:
    """Rows of ints (indices, 16-bit words or bytes) -> padded rows."""
    out = b""
    for row in rows:
        if bits_per_pixel == 16:
            raw = np.asarray(row, "<u2").tobytes()
        else:
            raw = pack(row, bits_per_pixel)
        out += raw + bytes(-len(raw) % 4)
    return out


def _rle8(index: np.ndarray) -> bytes:
    """Rows of 8-bit indices -> RLE8 (runs up to 255, end-of-line after each
    row, end-of-bitmap), bottom row first."""
    out = bytearray()
    for row in index[::-1]:
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x]:
                run += 1
            out += bytes([run, row[x]])
            x += run
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


def write_format_files(directory) -> Dict[str, str]:
    """Every kind of ``KINDS`` written under ``directory``: {kind: path}."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    paths = {}
    for kind, src in COMMITTED.items():
        paths[kind] = d / f"{kind}.jpg"
        paths[kind].write_bytes(src.read_bytes())
    base = (TESTDATA / BASE).read_bytes()
    paths["jpeg_cut"] = d / "jpeg_cut.jpg"
    paths["jpeg_cut"].write_bytes(base[:len(base) // 2])
    progressive = (TESTDATA / PROGRESSIVE).read_bytes()
    paths["jpeg_progressive_cut"] = d / "jpeg_progressive_cut.jpg"
    paths["jpeg_progressive_cut"].write_bytes(progressive[:965])
    damaged = bytearray((TESTDATA / RESTART).read_bytes())
    rng = np.random.RandomState(0)
    flips = 0
    while flips < 4:
        pos, bit = rng.randint(len(damaged) // 4, len(damaged) - 2), \
            rng.randint(8)
        if 0xFF not in (damaged[pos - 1], damaged[pos],
                        damaged[pos] ^ 1 << bit):
            damaged[pos] ^= 1 << bit
            flips += 1
    paths["jpeg_damaged"] = d / "jpeg_damaged.jpg"
    paths["jpeg_damaged"].write_bytes(bytes(damaged))
    rgb = native.decode_one(str(TESTDATA / BASE))
    small = rgb[::3, ::3]
    pngs = {
        "png": png_bytes(rgb, 2, 8),
        "png_gray16_adam7": png_bytes(
            small[..., 1:2].astype(np.int64) * 257, 0, 16, interlace=1),
        "png_palette4": png_bytes(
            small[..., :1] >> 4, 3, 4,
            palette=np.repeat(np.arange(16) * 17, 3).astype(np.uint8),
            trns=bytes(range(0, 256, 32))),
    }
    for kind, data in pngs.items():
        paths[kind] = d / f"{kind}.png"
        paths[kind].write_bytes(data)
    paths["png_named_jpg"] = d / "png_named_jpg.jpg"
    paths["png_named_jpg"].write_bytes(pngs["png"])
    h, w = rgb.shape[:2]
    paths["bmp"] = d / "bmp.bmp"
    paths["bmp"].write_bytes(bmp_bytes(
        w, h, 24, bmp_rows(rgb[::-1, :, ::-1].reshape(h, -1), 8)))
    index = (rgb[..., 1] >> 4).astype(np.uint8)
    gray = np.repeat(np.arange(16) * 17, 4).astype(np.uint8)
    paths["bmp_rle8"] = d / "bmp_rle8.bmp"
    paths["bmp_rle8"].write_bytes(bmp_bytes(w, h, 8, _rle8(index), 1,
                                            palette=gray.tobytes(),
                                            clrused=16))
    assert sorted(paths) == sorted(KINDS)
    return {k: str(paths[k]) for k in KINDS}
