"""Image files of every kind the port's reader takes, written from the
committed fixtures, for ``chip_smoke.py formats`` and the CPU tests.

    write_format_files(directory) -> {kind: path}

The kinds (``KINDS``): a baseline JPEG; the CMYK fixture and the committed
YCCK and arithmetic-coded (sequential, progressive) fixtures, which the
system libjpeg wrote; a JPEG cut at half its bytes, a progressive one cut
in its sixth scan (libjpeg smooths its blocks) and one with bit flips in
its scan data; a lossless JPEG (predictor 6, restart markers); PNGs (RGB
8-bit, grey 16-bit Adam7, a 4-bit palette with tRNS, and an RGB PNG
named ``.jpg``); BMPs (24-bit, RLE8); the committed WebP files, which
cv2.imwrite wrote (VP8 at quality 75, VP8L, VP8X with a lossless-coded
ALPH chunk); TIFFs (RGB LZW strips with predictor 2, Deflate tiles, an
8-bit palette in PackBits and MM order, 16-bit RGB LZW in a BigTIFF).  Every file is
made the same way on every machine, so the SHA-256 of each one's decode
(``data/testdata/formats/sha256.json``, cv2's decodes, which
``tests/test_torch_port_image_formats.py`` holds against cv2 and the
port) checks the port's reader wherever it runs.

``png_bytes``, ``chunk``, ``bmp_bytes``, ``lossless_jpeg_bytes`` and
``tiff_bytes`` are the writers: PNG of any colour type, bit depth and
interlace, each row with a filter of its own (None, Sub, Up, Average,
Paeth in turn); BMP of BI_RGB, BI_BITFIELDS or RLE rows; lossless JPEG
of any predictor, point transform, restart interval and sampling; TIFF
of any layout, compression and sample kind the port reads.
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
         "jpeg_damaged", "jpeg_lossless", "png",
         "png_gray16_adam7", "png_palette4", "png_named_jpg", "bmp",
         "bmp_rle8", "webp_lossy", "webp_lossless", "webp_alpha",
         "tiff_lzw", "tiff_deflate_tiled", "tiff_palette", "tiff_16bit")
COMMITTED = {"jpeg": TESTDATA / BASE,
             "jpeg_cmyk": TESTDATA / UNSUPPORTED[0],
             "jpeg_ycck": FORMATS / "ycck_420_q85_160x120.jpg",
             "jpeg_arithmetic": FORMATS / "arith_420_q80_160x120.jpg",
             "jpeg_arithmetic_progressive":
                 FORMATS / "arith_progressive_420_q80_160x120.jpg",
             "webp_lossy": FORMATS / "webp_q75_500x375.webp",
             "webp_lossless": FORMATS / "webp_lossless_160x120.webp",
             "webp_alpha": FORMATS / "webp_alpha_q75_160x120.webp"}


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


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes of ``lengths`` bits (MSB first) -> bytes, the last padded
    with 1 bits, 0xFF stuffed with 0x00 (JPEG entropy-coded data)."""
    top = int(lengths.max()) if len(lengths) else 0
    shifts = np.arange(top - 1, -1, -1)
    bits = (values[:, None] >> np.maximum(shifts - (top - lengths[:, None]),
                                          0)) & 1
    bits = bits[shifts[None, :] >= top - lengths[:, None]]
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, bits.dtype)])
    out = np.packbits(bits.astype(np.uint8)).tobytes()
    return out.replace(b"\xff", b"\xff\x00")


def _lossless_predict(x: np.ndarray, psv: int, first: np.ndarray,
                      initial: int) -> np.ndarray:
    """The predictions T.81 H.1.2.1 (libjpeg-turbo's jdlossls.c) makes for
    the samples ``x`` [h, w]: rows where ``first`` is set (a scan's first
    row, or the first after a restart) predict from the left, from
    ``initial`` in column 0; other rows' column 0 from above."""
    x = x.astype(np.int64)
    ra = np.roll(x, 1, 1)
    rb = np.roll(x, 1, 0)
    rc = np.roll(rb, 1, 1)
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = rb[:, 0]
    pred[first] = ra[first]
    pred[first, 0] = initial
    return pred


def lossless_jpeg_bytes(planes, psv: int = 1, al: int = 0,
                        restart_rows: int = 0, sampling=None,
                        precision: int = 8, ids=None, app: bytes = b"",
                        size=None) -> bytes:
    """Component planes (each [ceil(H v / Vmax), ceil(W h / Hmax)] samples
    in [0, 2**precision); or one [H, W, C] array at 1x1 sampling) -> a
    lossless (SOF3) Huffman JPEG of one interleaved scan: predictor
    ``psv`` (1..7), point transform ``al`` (the samples' low ``al`` bits
    dropped), a restart marker every ``restart_rows`` MCU rows, the
    components' ``sampling`` factors [(h, v), ...], ids ``ids`` (default
    1, 2, ...; libjpeg-turbo converts no colour space of a lossless file,
    so three components are RGB), ``app``
    segments after SOI, the image's (H, W) ``size`` (default the first
    plane's).  The difference categories 0..16 are 5-bit codes."""
    if not isinstance(planes, (list, tuple)):
        img = np.asarray(planes)
        img = img[..., None] if img.ndim == 2 else img
        planes = [img[..., c] for c in range(img.shape[2])]
    planes = [np.asarray(p, np.int64) >> al for p in planes]
    nc = len(planes)
    sampling = sampling or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height, width = size or planes[0].shape
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    single = nc == 1
    if single:
        mcux, mcuy = planes[0].shape[1], planes[0].shape[0]
        sampling = [(1, 1)]
    initial = 1 << (precision - al - 1)
    diffs = []          # per component: [mcuy * v, mcux * h], 0 past it
    for p, (h, v) in zip(planes, sampling):
        rows = np.arange(p.shape[0])
        first = rows % v == 0
        first &= (rows // v) % restart_rows == 0 if restart_rows else \
            rows == 0
        d = (p - _lossless_predict(p, psv, first, initial)) & 0xFFFF
        full = np.zeros((mcuy * v, mcux * h), np.int64)
        full[:p.shape[0], :p.shape[1]] = d
        diffs.append(full)
    order = []          # each MCU row's differences in MCU order
    for m in range(mcuy):
        parts = [d[m * v:(m + 1) * v].reshape(v, mcux, h).transpose(1, 0, 2)
                 .reshape(mcux, v * h) for d, (h, v) in zip(diffs, sampling)]
        order.append(np.concatenate(parts, 1).reshape(-1))
    sym_bits = 5
    data = b""
    interval = restart_rows or mcuy
    for k, start in enumerate(range(0, mcuy, interval)):
        d = np.concatenate(order[start:start + interval])
        signed = np.where(d >= 32768, d - 65536, d)
        a = np.abs(signed)
        cat = np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))) + 1,
                       0).astype(np.int64)
        cat[d == 32768] = 16
        mag = np.where(signed >= 0, signed, signed + (1 << cat) - 1)
        extra = np.where((cat > 0) & (cat < 16), cat, 0)
        values = cat << extra | np.where(extra > 0, mag, 0)
        data += _pack_bits(values, sym_bits + extra)
        if start + interval < mcuy:
            data += bytes([0xFF, 0xD0 + (k & 7)])
    dc_bits = bytearray(16)
    dc_bits[sym_bits - 1] = 17
    return (b"\xff\xd8" + app
            + _segment(0xC3, bytes([precision]) + struct.pack(
                ">HH", height, width) + bytes([nc]) + b"".join(
                    bytes([i, h << 4 | v, 0])
                    for i, (h, v) in zip(ids, sampling)))
            + _segment(0xC4, b"\x00" + bytes(dc_bits) + bytes(range(17)))
            + (_segment(0xDD, struct.pack(">H", restart_rows * mcux))
               if restart_rows else b"")
            + _segment(0xDA, bytes([nc]) + b"".join(bytes([i, 0])
                                                    for i in ids)
                       + bytes([psv, 0, al]))
            + data + b"\xff\xd9")


# ---------------------------------------------------------------------------
# TIFF

def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB first, 9 to 12-bit codes widened as libtiff's
    decoder expects, a Clear code first and when the table is full, EOI
    last)."""
    out, acc, nacc = bytearray(), 0, 0
    width, table = 9, {bytes([i]): i for i in range(256)}
    nxt = 258

    def put(code):
        nonlocal acc, nacc
        acc = acc << width | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append(acc >> nacc & 0xFF)
        acc &= (1 << nacc) - 1

    put(256)
    w = b""
    for i in range(len(data)):
        c = data[i:i + 1]
        if w + c in table:
            w += c
            continue
        put(table[w])
        table[w + c] = nxt
        nxt += 1
        if nxt == 1 << width and width < 12:
            width += 1
        if nxt == 4094:
            put(256)
            table = {bytes([k]): k for k in range(256)}
            nxt, width = 258, 9
        w = c
    if w:
        put(table[w])
        nxt += 1
        if nxt == 1 << width and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append(acc << (8 - nacc) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 16: "Q"}


def tiff_bytes(samples, bits: int = 8, photometric: int = 2,
               compression: int = 1, predictor: int = 1, planar: int = 1,
               rows_per_strip=None, tile=None, big_endian: bool = False,
               bigtiff: bool = False, extra_samples=None, colormap=None,
               orientation=None, pages=1, extra_tags=None) -> bytes:
    """samples [H, W, C] (ints at ``bits`` bits) -> a TIFF: strips of
    ``rows_per_strip`` rows (default all) or ``tile`` (w, h) tiles,
    chunky (planar 1) or planar (2), compression 1, 5 (LZW), 8 / 32946
    (Deflate) or 32773 (PackBits), predictor 2 (horizontal differencing
    at 8 and 16 bits), MM or II byte order, classic or BigTIFF, with
    ExtraSamples, a ColorMap (3 x 2**bits 16-bit entries), an
    Orientation, and ``pages`` copies of the IFD (each page's pixels
    inverted).  ``extra_tags`` {tag: (type, [values])} adds or replaces
    entries."""
    samples = np.asarray(samples, np.int64)
    h, w, spp = samples.shape
    e = ">" if big_endian else "<"
    dt = np.dtype(e + ("u2" if bits == 16 else "u1"))

    def rows_bytes(block):
        """[rows, cols, c] -> packed rows (predictor applied)."""
        block = block.copy()
        if predictor == 2:
            block[:, 1:] = block[:, 1:] - block[:, :-1]
            block &= (1 << bits) - 1
        if bits >= 8:
            return block.astype(dt).tobytes()
        return b"".join(pack(r, bits) for r in block)

    def compress(raw: bytes) -> bytes:
        if compression == 5:
            return lzw_encode(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:
            return packbits_encode(raw)
        return raw

    def page_chunks(img):
        planes = [img[..., c:c + 1] for c in range(spp)] if planar == 2 \
            else [img]
        chunks = []
        for plane in planes:
            if tile:
                tw, th = tile
                for ty in range(0, h, th):
                    for tx in range(0, w, tw):
                        t = np.zeros((th, tw, plane.shape[2]), np.int64)
                        part = plane[ty:ty + th, tx:tx + tw]
                        t[:part.shape[0], :part.shape[1]] = part
                        chunks.append(compress(rows_bytes(t)))
            else:
                rps = rows_per_strip or h
                for y in range(0, h, rps):
                    chunks.append(compress(rows_bytes(plane[y:y + rps])))
        return chunks

    off_fmt = "Q" if bigtiff else "I"
    head = ((b"MM" if big_endian else b"II")
            + (struct.pack(e + "HHHQ", 43, 8, 0, 16) if bigtiff
               else struct.pack(e + "HI", 42, 8)))
    out = bytearray(head)
    link_at = None                           # where the previous IFD links
    for page in range(pages):
        img = samples if page == 0 else (1 << bits) - 1 - samples
        chunks = page_chunks(img)
        offsets = []
        for c in chunks:
            offsets.append(len(out))
            out += c + bytes(len(c) & 1)
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
                259: (3, [compression]), 262: (3, [photometric]),
                277: (3, [spp]), 284: (3, [planar])}
        if tile:
            tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]]),
                         324: (16 if bigtiff else 4, offsets),
                         325: (4, [len(c) for c in chunks])})
        else:
            tags.update({273: (16 if bigtiff else 4, offsets),
                         278: (4, [rows_per_strip or h]),
                         279: (4, [len(c) for c in chunks])})
        if predictor != 1:
            tags[317] = (3, [predictor])
        if extra_samples is not None:
            tags[338] = (3, list(extra_samples))
        if colormap is not None:
            tags[320] = (3, list(np.asarray(colormap).reshape(-1)))
        if orientation is not None:
            tags[274] = (3, [orientation])
        tags.update(extra_tags or {})
        # the values that do not fit in the entry go before the IFD
        inline = 8 if bigtiff else 4
        entries = []
        for tag in sorted(tags):
            typ, vals = tags[tag]
            raw = struct.pack(e + _TIFF_TYPES[typ] * len(vals), *vals) \
                if typ != 2 else bytes(vals)
            if len(raw) > inline:
                at = len(out)
                out += raw + bytes(len(raw) & 1)
                raw = struct.pack(e + off_fmt, at)
            entries.append((tag, typ, len(vals), raw.ljust(inline, b"\0")))
        ifd_at = len(out)
        if link_at is not None:
            out[link_at:link_at + inline] = struct.pack(e + off_fmt, ifd_at)
        else:
            out[len(head) - inline:len(head)] = struct.pack(e + off_fmt,
                                                            ifd_at)
        out += struct.pack(e + ("Q" if bigtiff else "H"), len(entries))
        for tag, typ, count, raw in entries:
            out += struct.pack(e + ("HHQ" if bigtiff else "HHI"), tag, typ,
                               count) + raw
        link_at = len(out)
        out += bytes(inline)
    return bytes(out)


def write_format_files(directory) -> Dict[str, str]:
    """Every kind of ``KINDS`` written under ``directory``: {kind: path}."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    paths = {}
    for kind, src in COMMITTED.items():
        paths[kind] = d / f"{kind}{src.suffix}"
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
    paths["jpeg_lossless"] = d / "jpeg_lossless.jpg"
    paths["jpeg_lossless"].write_bytes(lossless_jpeg_bytes(small, psv=6,
                                                           restart_rows=8))
    i = np.arange(256)
    palette = np.stack([i, 255 - i, i * 7 % 256]) * 257   # 16-bit entries
    tiffs = {
        "tiff_lzw": tiff_bytes(rgb, compression=5, predictor=2,
                               rows_per_strip=16),
        "tiff_deflate_tiled": tiff_bytes(rgb, compression=8, predictor=2,
                                         tile=(64, 64)),
        "tiff_palette": tiff_bytes(rgb[..., 1:2], photometric=3,
                                   compression=32773, colormap=palette,
                                   big_endian=True),
        "tiff_16bit": tiff_bytes(small.astype(np.int64) * 257, bits=16,
                                 compression=5, predictor=2, bigtiff=True),
    }
    for kind, data in tiffs.items():
        paths[kind] = d / f"{kind}.tiff"
        paths[kind].write_bytes(data)
    assert sorted(paths) == sorted(KINDS)
    return {k: str(paths[k]) for k in KINDS}
