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
8-bit palette in PackBits and MM order, 16-bit RGB LZW in a BigTIFF, and
``tiff_kinds``: JPEG compression of the 500x375 fixture split into
JPEGTables and a strip and of the CMYK fixture, YCbCr in 2x2 units and in
clipped 4x4 tiles, CMYK, CIELab, FillOrder 2, old-style LZW, a
ThunderScan palette, signed samples; and the committed files libtiff
wrote: JPEG YCbCr strips and tiles, CCITT Group 3 2-D, Group 4 and RLE,
SGILog LogLuv and LogL, 24-bit LogLuv (SGILog24) in strips and in tiles,
``tests/test_torch_port_tiff.py::test_committed_tiff_fixtures`` their
recipe; and the Group 3 file with its second strip's byte count cut to
half, which libtiff 4.7 decodes again from the strip's start); the
committed JPEG 2000 files (cv2's writes of the 500x375 fixture at rate
x1000 25 and lossless; Pillow's tiled three-layer 9/7 JP2, its RPCL J2K
codestream with 32x32 precincts and 16x16 code-blocks and its 16-bit
grey JP2; libopenjp2's J2K codestream with every code-block style bit,
SOP and EPH markers, precincts and tile-parts by resolution; its Part 2
J2K codestream, CBD, MCT, MCC and MCO from opj_set_MCT, with the COD
transform value set to 1, and that codestream in a JP2 file,
``tests/test_torch_port_jp2.py::test_committed_part2_fixture`` its
recipe); GIFs (the
500x375 image in 256 colours, and an interlaced frame at an offset
inside a larger screen with a local table and a transparent index); a
P6 PPM, a 16-bit ASCII P2 PGM, a P7 PAM (TUPLTYPE RGB), a PF PFM
(scale -0.5); Sun rasters (24-bit, 8-bit with a colour map); a Radiance
HDR of RLE scanlines; the committed AVIFs (``avif_stage_files``,
``avif_screen_files``, ``avif_depth_files``, ``avif_layer_files`` and
``avif_inter_files`` the recipes of the later ones: the stages after
CDEF, screen content and a grid, 10 and 12 bits, an image sequence,
premultiplied alpha, spatial layers, compound prediction from a scaled
reference, global motion, a frame lost, an alpha grid).  Every file is
made the same way on every
machine, so the SHA-256 of each one's decode
(``data/testdata/formats/sha256.json``, cv2's decodes, which
``tests/test_torch_port_image_formats.py`` holds against cv2 and the
port) checks the port's reader wherever it runs.

``png_bytes``, ``chunk``, ``bmp_bytes``, ``lossless_jpeg_bytes``,
``tiff_bytes``, ``jpeg_tiff_bytes``, ``thunderscan_bytes``,
``gif_bytes``, ``sun_bytes``, ``hdr_bytes`` and ``jp2_bytes`` are the
writers (``set_tiff_counts`` replaces a TIFF's strip or tile byte
counts): PNG of any colour type, bit depth and
interlace, each row with a filter of its own (None, Sub, Up, Average,
Paeth in turn); BMP of BI_RGB, BI_BITFIELDS or RLE rows; lossless JPEG
of any predictor, point transform, restart interval and sampling; TIFF
of any layout, compression and sample kind the port writes (YCbCr data
units, FillOrder 2, old-style LZW, strips given as stored); JPEG
compression from a baseline JPEG; ThunderScan codes; GIF of any
screen, colour tables, frames (``gif_image``: offset, interlace,
transparency, disposal, minimum code size, a deferred clear); Sun raster
of any depth, type and colour map, byte-encoded when asked; Radiance HDR
of RLE or flat scanlines under any header and resolution line; the JP2
boxes (ihdr, colr, pclr, cmap, cdef) around a J2K codestream.
``idct_case`` is the reduced IDCTs' damaged JPEG, ``IDCT_HASHES`` cv2's
decodes of it at 1/1, 1/2, 1/4 and 1/8.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict

import numpy as np

from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.formats import (PNG_SIGNATURE,
                                                     _tiff_ifd)
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
         "tiff_lzw", "tiff_deflate_tiled", "tiff_palette", "tiff_16bit",
         "jp2_lossy", "jp2_lossless", "jp2_tiles_layers", "j2k_rpcl_precincts",
         "j2k_styles", "jp2_grey16", "gif", "gif_interlaced_offset", "ppm",
         "pgm_ascii16", "pam", "pfm", "ras_rgb24", "ras_map8", "hdr",
         "tiff_jpeg_ycbcr", "tiff_jpeg_strips", "tiff_jpeg_tiles",
         "tiff_jpeg_cmyk", "tiff_ycbcr", "tiff_ycbcr_44_tiles", "tiff_cmyk",
         "tiff_cielab", "tiff_g3_2d", "tiff_g4", "tiff_ccitt_rle",
         "tiff_fillorder2", "tiff_lzw_old", "tiff_thunderscan",
         "tiff_signed", "tiff_logluv", "tiff_logl", "tiff_logluv24",
         "tiff_logluv24_tiles", "tiff_g3_cut", "j2k_part2", "jp2_part2",
         "avif_cv2", "avif_pillow", "avif_444", "avif_422", "avif_400",
         "avif_lossless", "avif_tiles_sb128", "avif_odd", "avif_500x375",
         "avif_wiener", "avif_sgrproj", "avif_superres", "avif_film_grain",
         "avif_palette_444", "avif_palette_420", "avif_intrabc",
         "avif_grid_cropped", "avif_10bit_420", "avif_10bit_444_lr",
         "avif_10bit_film_grain", "avif_12bit_422", "avif_10bit_400",
         "avif_10bit_screen", "avif_sequence", "avif_prem",
         "avif_layers_key", "avif_layers_realtime", "avif_layers_quality",
         "avif_layers_scaled", "avif_layers_10bit", "avif_layers_ops",
         "avif_scaled_compound", "avif_global_motion", "avif_lost_frame",
         "avif_alpha_grid")
COMMITTED = {"jpeg": TESTDATA / BASE,
             "jpeg_cmyk": TESTDATA / UNSUPPORTED[0],
             "jpeg_ycck": FORMATS / "ycck_420_q85_160x120.jpg",
             "jpeg_arithmetic": FORMATS / "arith_420_q80_160x120.jpg",
             "jpeg_arithmetic_progressive":
                 FORMATS / "arith_progressive_420_q80_160x120.jpg",
             "webp_lossy": FORMATS / "webp_q75_500x375.webp",
             "webp_lossless": FORMATS / "webp_lossless_160x120.webp",
             "webp_alpha": FORMATS / "webp_alpha_q75_160x120.webp",
             "jp2_lossy": FORMATS / "jp2_lossy_x25_500x375.jp2",
             "jp2_lossless": FORMATS / "jp2_lossless_500x375.jp2",
             "jp2_tiles_layers": FORMATS / "jp2_tiles_layers_160x120.jp2",
             "j2k_rpcl_precincts": FORMATS / "j2k_rpcl_precincts_160x120.j2k",
             "j2k_styles": FORMATS / "j2k_styles_sop_eph_tileparts_128x96.j2k",
             "jp2_grey16": FORMATS / "jp2_grey16_160x120.jp2",
             "tiff_jpeg_strips":
                 FORMATS / "tiff_jpeg_ycbcr_strips_160x120.tif",
             "tiff_jpeg_tiles": FORMATS / "tiff_jpeg_tiles_160x120.tif",
             "tiff_g3_2d": FORMATS / "tiff_g3_2d_fill_160x120.tif",
             "tiff_g4": FORMATS / "tiff_g4_160x120.tif",
             "tiff_ccitt_rle": FORMATS / "tiff_ccitt_rle_lsb_160x120.tif",
             "tiff_logluv": FORMATS / "tiff_sgilog_logluv_54x40.tif",
             "tiff_logl": FORMATS / "tiff_sgilog_logl_54x40.tif",
             "tiff_logluv24": FORMATS / "tiff_sgilog24_strips_54x40.tif",
             "tiff_logluv24_tiles": FORMATS / "tiff_sgilog24_tiles_54x40.tif",
             "j2k_part2": FORMATS / "j2k_part2_mct_160x120.j2k",
             "avif_cv2": FORMATS / "avif_cv2_160x120.avif",
             "avif_pillow": FORMATS / "avif_pillow_160x120.avif",
             "avif_444": FORMATS / "avif_444_q60_160x120.avif",
             "avif_422": FORMATS / "avif_422_q60_160x120.avif",
             "avif_400": FORMATS / "avif_400_q60_160x120.avif",
             "avif_lossless": FORMATS / "avif_lossless_80x60.avif",
             "avif_tiles_sb128": FORMATS / "avif_tiles_sb128_160x120.avif",
             "avif_odd": FORMATS / "avif_q60_167x125.avif",
             "avif_500x375": FORMATS / "avif_q50_500x375.avif",
             "avif_wiener": FORMATS / "avif_wiener_160x120.avif",
             "avif_sgrproj": FORMATS / "avif_sgrproj_sb128_160x120.avif",
             "avif_superres": FORMATS / "avif_superres_d16_tiles2_288x64.avif",
             "avif_film_grain": FORMATS / "avif_film_grain1_160x120.avif",
             "avif_palette_444": FORMATS / "avif_palette_444_160x120.avif",
             "avif_palette_420":
                 FORMATS / "avif_palette_420_sb128_157x117.avif",
             "avif_intrabc": FORMATS / "avif_intrabc_420_160x120.avif",
             "avif_grid_cropped": FORMATS / "avif_grid_2x2_120x100.avif",
             "avif_10bit_420": FORMATS / "avif_10bit_420_160x120.avif",
             "avif_10bit_444_lr": FORMATS / "avif_10bit_444_lr_160x120.avif",
             "avif_10bit_film_grain":
                 FORMATS / "avif_10bit_film_grain1_160x120.avif",
             "avif_12bit_422": FORMATS / "avif_12bit_422_160x120.avif",
             "avif_10bit_400": FORMATS / "avif_10bit_400_160x120.avif",
             "avif_10bit_screen": FORMATS / "avif_10bit_screen_160x120.avif",
             "avif_sequence": FORMATS / "avif_sequence3_160x120.avif",
             "avif_prem": FORMATS / "avif_10bit_prem_160x120.avif",
             "avif_layers_key": FORMATS / "avif_layers_key3_160x120.avif",
             "avif_layers_realtime":
                 FORMATS / "avif_layers_realtime3_160x120.avif",
             "avif_layers_quality":
                 FORMATS / "avif_layers_quality3_160x120.avif",
             "avif_layers_scaled":
                 FORMATS / "avif_layers_scaled3_160x120.avif",
             "avif_layers_10bit": FORMATS / "avif_layers_10bit3_160x120.avif",
             "avif_layers_ops": FORMATS / "avif_layers_ops2_160x120.avif",
             "avif_scaled_compound":
                 FORMATS / "avif_scaled_compound6_73x55.avif",
             "avif_global_motion": FORMATS / "avif_global_motion5_128x96.avif",
             "avif_lost_frame": FORMATS / "avif_lost_frame4_128x96.avif",
             "avif_alpha_grid":
                 FORMATS / "avif_10bit_alpha_grid_prem_128x128.avif"}
AVIF_KINDS = tuple(k for k in KINDS if k.startswith("avif"))


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

def lzw_encode(data: bytes, old: bool = False) -> bytes:
    """TIFF LZW (MSB first, 9 to 12-bit codes widened as libtiff's
    decoder expects, a Clear code first and when the table is full, EOI
    last); with ``old`` the old LSB-first kind that libtiff reads through
    LZWDecodeCompat, codes widened one entry later."""
    out, acc, nacc = bytearray(), 0, 0
    width, table = 9, {bytes([i]): i for i in range(256)}
    nxt = 258
    late = int(old)

    def put(code):
        nonlocal acc, nacc
        if old:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
            return
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
        if nxt == (1 << width) + late and width < 12:
            width += 1
        if nxt == 4094:
            put(256)
            table = {bytes([k]): k for k in range(256)}
            nxt, width = 258, 9
        w = c
    if w:
        put(table[w])
        nxt += 1
        if nxt == (1 << width) + late and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append(acc & 0xFF if old else acc << (8 - nacc) & 0xFF)
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


_TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 7: "B", 16: "Q"}
_REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                          np.uint8)


def _ycbcr_units(block: np.ndarray, hs: int, vs: int) -> bytes:
    """[rows, cols, 3] Y, Cb, Cr -> TIFF's packed data units of hs x vs
    luma samples, then Cb and Cr of the unit's first pixel; the last
    units repeat the block's last row and column."""
    rows, cols = block.shape[:2]
    uy, ux = -(-rows // vs), -(-cols // hs)
    pad = np.pad(block, ((0, uy * vs - rows), (0, ux * hs - cols), (0, 0)),
                 mode="edge").astype(np.uint8)
    y = pad[..., 0].reshape(uy, vs, ux, hs).transpose(0, 2, 1, 3)
    chroma = pad[::vs, ::hs, 1:]
    units = np.concatenate([y.reshape(uy, ux, hs * vs), chroma], -1)
    return units.tobytes()


def set_tiff_counts(data: bytes, counts) -> bytes:
    """A classic TIFF with its StripByteCounts or TileByteCounts replaced
    where ``counts`` is not None, in the entry's own type (libtiff writes
    SHORT counts where they fit)."""
    e = "<" if data[:2] == b"II" else ">"
    at = struct.unpack(e + "I", data[4:8])[0]
    out = bytearray(data)
    for k in range(struct.unpack(e + "H", data[at:at + 2])[0]):
        o = at + 2 + 12 * k
        tag, typ, n = struct.unpack(e + "HHI", data[o:o + 8])
        if tag in (279, 325):
            code, size = ("H", 2) if typ == 3 else ("I", 4)
            vo = o + 8 if n * size <= 4 else struct.unpack(
                e + "I", data[o + 8:o + 12])[0]
            for i, c in enumerate(counts):
                if c is not None:
                    out[vo + size * i:vo + size * (i + 1)] = struct.pack(
                        e + code, c)
    return bytes(out)


def tiff_bytes(samples, bits: int = 8, photometric: int = 2,
               compression: int = 1, predictor: int = 1, planar: int = 1,
               rows_per_strip=None, tile=None, big_endian: bool = False,
               bigtiff: bool = False, extra_samples=None, colormap=None,
               orientation=None, pages=1, extra_tags=None,
               ycbcr_subsampling=None, old_lzw: bool = False,
               fill_order: int = 1, chunks=None) -> bytes:
    """samples [H, W, C] (ints at ``bits`` bits) -> a TIFF: strips of
    ``rows_per_strip`` rows (default all) or ``tile`` (w, h) tiles,
    chunky (planar 1) or planar (2), compression 1, 5 (LZW; the old
    LSB-first kind with ``old_lzw``), 8 / 32946 (Deflate) or 32773
    (PackBits), predictor 2 (horizontal differencing at 8 and 16 bits),
    MM or II byte order, classic or BigTIFF, with ExtraSamples, a
    ColorMap (3 x 2**bits 16-bit entries), an Orientation, and ``pages``
    copies of the IFD (each page's pixels inverted).  With
    ``ycbcr_subsampling`` (h, v) the 3 samples (Y, Cb, Cr) are packed in
    data units of h x v luma samples and the Cb and Cr of the unit's first
    pixel (edge units repeat their last row and column), YCbCrSubsampling
    written; ``fill_order`` 2 writes each compressed byte's bits reversed
    and the FillOrder tag.  ``chunks`` gives the first page's strips or
    tiles as stored (``samples`` then gives only the shape).
    ``extra_tags`` {tag: (type, [values])} adds or replaces entries."""
    samples = np.asarray(samples, np.int64)
    h, w, spp = samples.shape
    e = ">" if big_endian else "<"
    dt = np.dtype(e + ("u2" if bits == 16 else "u1"))

    def rows_bytes(block):
        """[rows, cols, c] -> packed rows (predictor applied)."""
        block = block.copy()
        if ycbcr_subsampling:
            return _ycbcr_units(block, *ycbcr_subsampling)
        if predictor == 2:
            block[:, 1:] = block[:, 1:] - block[:, :-1]
            block &= (1 << bits) - 1
        if bits >= 8:
            return block.astype(dt).tobytes()
        return b"".join(pack(r, bits) for r in block)

    def compress(raw: bytes) -> bytes:
        if fill_order == 2:
            return bytes(_REVERSED_BITS[np.frombuffer(
                compress_msb(raw), np.uint8)])
        return compress_msb(raw)

    def compress_msb(raw: bytes) -> bytes:
        if compression == 5:
            return lzw_encode(raw, old_lzw)
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
        stored = chunks if chunks is not None and page == 0 \
            else page_chunks(img)
        offsets = []
        for c in stored:
            offsets.append(len(out))
            out += c + bytes(len(c) & 1)
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
                259: (3, [compression]), 262: (3, [photometric]),
                277: (3, [spp]), 284: (3, [planar])}
        if tile:
            tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]]),
                         324: (16 if bigtiff else 4, offsets),
                         325: (4, [len(c) for c in stored])})
        else:
            tags.update({273: (16 if bigtiff else 4, offsets),
                         278: (4, [rows_per_strip or h]),
                         279: (4, [len(c) for c in stored])})
        if predictor != 1:
            tags[317] = (3, [predictor])
        if extra_samples is not None:
            tags[338] = (3, list(extra_samples))
        if colormap is not None:
            tags[320] = (3, list(np.asarray(colormap).reshape(-1)))
        if orientation is not None:
            tags[274] = (3, [orientation])
        if ycbcr_subsampling:
            tags[530] = (3, list(ycbcr_subsampling))
        if fill_order != 1:
            tags[266] = (3, [fill_order])
        tags.update(extra_tags or {})
        # the values that do not fit in the entry go before the IFD
        inline = 8 if bigtiff else 4
        entries = []
        for tag in sorted(tags):
            typ, vals = tags[tag]
            # RATIONAL values come as numerator, denominator pairs
            count = len(vals) // 2 if typ == 5 else len(vals)
            raw = struct.pack(e + "I" * len(vals) if typ == 5 else
                              e + _TIFF_TYPES[typ] * len(vals), *vals) \
                if typ != 2 else bytes(vals)
            if len(raw) > inline:
                at = len(out)
                out += raw + bytes(len(raw) & 1)
                raw = struct.pack(e + off_fmt, at)
            entries.append((tag, typ, count, raw.ljust(inline, b"\0")))
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


def _ycbcr_of(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB -> Y, Cb, Cr bytes by the JFIF formulas, rounded."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    ycc = np.stack([y, (b - y) / 1.772 + 128, (r - y) / 1.402 + 128], -1)
    return np.clip(np.round(ycc), 0, 255).astype(np.int64)


def tiff_kinds(jpeg: bytes, small: np.ndarray) -> Dict[str, bytes]:
    """The TIFFs of ``KINDS`` that libtiff's other photometrics and codecs
    make, from a baseline JPEG and its pixels cut to ``small``: JPEG
    compression (the JPEG split into JPEGTables and a strip; the CMYK
    fixture), YCbCr of the JFIF formulas in 2x2 units and in clipped 4x4
    tiles, CMYK as 255 - RGB with K their minimum, CIELab bytes from the
    RGB bytes (any bytes are L, a and b), FillOrder 2, old-style LZW,
    ThunderScan under a 4-bit palette, signed samples."""
    ycc = _ycbcr_of(small)
    cmy = 255 - small.astype(np.int64)
    k = cmy.min(-1, keepdims=True)
    return {
        "tiff_jpeg_ycbcr": jpeg_tiff_bytes(jpeg),
        "tiff_jpeg_cmyk": jpeg_tiff_bytes(
            (TESTDATA / UNSUPPORTED[0]).read_bytes(), photometric=5),
        "tiff_ycbcr": tiff_bytes(ycc, photometric=6, compression=5,
                                 ycbcr_subsampling=(2, 2),
                                 rows_per_strip=16),
        "tiff_ycbcr_44_tiles": tiff_bytes(
            ycc, photometric=6, compression=8, ycbcr_subsampling=(4, 4),
            tile=(32, 32), extra_tags={532: (5, [16, 1, 235, 1, 128, 1,
                                                 240, 1, 128, 1, 240, 1])}),
        "tiff_cmyk": tiff_bytes(np.concatenate([cmy - k, k], -1),
                                photometric=5, compression=8, predictor=2),
        "tiff_cielab": tiff_bytes(small, photometric=8, compression=32773,
                                  rows_per_strip=32),
        "tiff_fillorder2": tiff_bytes(small, compression=5, predictor=2,
                                      fill_order=2, rows_per_strip=24),
        "tiff_lzw_old": tiff_bytes(small, compression=5, old_lzw=True,
                                   rows_per_strip=40),
        "tiff_thunderscan": tiff_bytes(
            small[..., 1:2] >> 4, bits=4, photometric=3,
            colormap=np.stack([np.arange(16) * 17, 255 - np.arange(16) * 17,
                               np.arange(16) * 9]) * 257,
            chunks=[thunderscan_bytes(small[..., 1] >> 4)],
            extra_tags={259: (3, [32809])}),
        "tiff_signed": tiff_bytes(small, compression=32773,
                                  extra_tags={339: (3, [2, 2, 2])}),
    }


def jpeg_tiff_bytes(jpeg: bytes, photometric: int = 6,
                    extra_tags=None) -> bytes:
    """A baseline JPEG -> a TIFF of JPEG compression (7) with one strip:
    its DQT and DHT segments moved into a JPEGTables stream (SOI, the
    tables, EOI; tag 347) and the rest, an abbreviated stream, as the
    strip; ``photometric`` 6 (YCbCr, with YCbCrSubsampling from the frame's
    component 0), 2, 1 or 5 as the samples mean."""
    segs = jpeg_segments(jpeg)
    tables = b"".join(jpeg[a:b] for m, a, b in segs if m in (0xC4, 0xDB))
    strip = jpeg[:2] + b"".join(jpeg[a:b] for m, a, b in segs
                                if m not in (0xC4, 0xDB)) + \
        jpeg[segs[-1][2]:]
    sof = next(a for m, a, b in segs if m in (0xC0, 0xC1))
    h, w = struct.unpack(">HH", jpeg[sof + 5:sof + 9])
    ncomp = jpeg[sof + 9]
    tags = {347: (7, list(b"\xff\xd8" + tables + b"\xff\xd9"))}
    if photometric == 6:
        tags[530] = (3, [jpeg[sof + 11] >> 4, jpeg[sof + 11] & 15])
    tags.update(extra_tags or {})
    return tiff_bytes(np.zeros((h, w, ncomp), np.int64), compression=7,
                      photometric=photometric, chunks=[strip],
                      extra_tags=tags)


def thunderscan_bytes(pixels) -> bytes:
    """[H, W] 4-bit pixels -> ThunderScan data (tif_thunder.c's codes),
    each row coded alone from a last pixel of 0: a run of the last pixel
    (up to 63), else three 2-bit or two 3-bit deltas where they reach the
    next pixels (a skip code where a row ends first), else a raw
    pixel."""
    out = bytearray()
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    for row in np.asarray(pixels, np.int64):
        last, i, n = 0, 0, len(row)
        while i < n:
            run = 0
            while i + run < n and run < 63 and row[i + run] == last:
                run += 1
            if run >= 2:
                out.append(run)
                i += run
                continue
            nxt = list(row[i:i + 3])
            d, prev = [], last
            for v in nxt:
                d.append(int(v) - int(prev))
                prev = v
            if len(d) >= 2 and all(x in two for x in d[:3]):
                codes = [two[x] for x in d[:3]] + [2] * (3 - len(d[:3]))
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                i += len(d[:3])
                last = int(row[i - 1])
                continue
            if all(x in three for x in d[:2]):
                codes = [three[x] for x in d[:2]] + [4] * (2 - len(d[:2]))
                out.append(0x80 | codes[0] << 3 | codes[1])
                i += len(d[:2])
                last = int(row[i - 1])
                continue
            out.append(0xC0 | int(row[i]))
            last = int(row[i])
            i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# GIF

def gif_lzw(indices: bytes, min_code_size: int = 8,
            deferred_clear: bool = False, clear_first: bool = True) -> bytes:
    """GIF LZW (LSB first, codes from min_code_size + 1 bits, widened when
    the next free code reaches the width, up to 12 bits): a Clear code
    first, another when the table fills -- or with ``deferred_clear``
    none, the rest coded with the full table at 12 bits -- and the End
    code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out, acc, nacc = bytearray(), 0, 0
    fresh = {bytes([i]): i for i in range(clear)}
    width, table, nxt = min_code_size + 1, dict(fresh), end + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    if clear_first:
        put(clear)
    w = b""
    for i in range(len(indices)):
        c = indices[i:i + 1]
        if w + c in table:
            w += c
            continue
        put(table[w])
        if nxt == 1 << width and width < 12:    # as giflib widens
            width += 1
        if nxt < 4096:
            table[w + c] = nxt
            nxt += 1
        elif not deferred_clear:
            put(clear)
            table, nxt, width = dict(fresh), end + 1, min_code_size + 1
        w = c
    if w:
        put(table[w])
        if nxt == 1 << width and width < 12:
            width += 1
    put(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_blocks(data: bytes) -> bytes:
    """Data sub-blocks of up to 255 bytes and the terminator."""
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def gif_image(indices, left: int = 0, top: int = 0, palette=None,
              interlace: bool = False, transparent=None,
              min_code_size: int = 8, deferred_clear: bool = False,
              disposal: int = 0) -> bytes:
    """One frame: a graphic control extension (when ``transparent`` is an
    index or ``disposal`` is set), the image descriptor, its local colour
    table (``palette`` [n, 3] RGB, n a power of two from 2 to 256) and
    its LZW data; ``indices`` [h, w] in display order, stored in the four
    interlace passes with ``interlace``."""
    idx = np.asarray(indices, np.uint8)
    h, w = idx.shape
    out = b""
    if transparent is not None or disposal:
        out += b"\x21\xf9\x04" + bytes([disposal << 2 | (
            transparent is not None)]) + b"\0\0" + bytes(
            [transparent or 0]) + b"\0"
    flags = 0
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        flags = 0x80 | (len(palette).bit_length() - 2)
    if interlace:
        flags |= 0x40
        idx = idx[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                  np.arange(2, h, 4), np.arange(1, h, 2)])]
    out += b"," + struct.pack("<HHHHB", left, top, w, h, flags)
    if palette is not None:
        out += palette.tobytes()
    return out + bytes([min_code_size]) + gif_blocks(gif_lzw(
        idx.tobytes(), min_code_size, deferred_clear))


def gif_bytes(w: int, h: int, frames, palette=None, background: int = 0,
              version: bytes = b"89a", extensions: bytes = b"") -> bytes:
    """A GIF file: the logical screen w x h, the global colour table
    (``palette`` [n, 3] RGB, or none), the background index, then
    ``extensions`` (raw bytes) and the frames (``gif_image``'s), then the
    trailer."""
    flags = 0
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        flags = 0x80 | 0x70 | (len(palette).bit_length() - 2)
    out = b"GIF" + version + struct.pack("<HHBBB", w, h, flags, background, 0)
    if palette is not None:
        out += palette.tobytes()
    return out + extensions + b"".join(frames) + b";"


# ---------------------------------------------------------------------------
# Sun raster

RT_OLD, RT_STANDARD, RT_BYTE_ENCODED, RT_FORMAT_RGB = 0, 1, 2, 3


def sun_rle(data: bytes) -> bytes:
    """Sun's byte encoding: runs of 3-256 equal bytes as 0x80, n - 1,
    byte; a lone 0x80 as 0x80 0x00; other bytes as they are."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 256 and data[i + run] == data[i]:
            run += 1
        if run >= 3 or data[i] == 0x80 and run > 1:
            out += bytes([0x80, run - 1, data[i]])
            i += run
        elif data[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def sun_bytes(pixels, bpp: int, kind: int = RT_STANDARD, colormap=None,
              maptype=None, length=None) -> bytes:
    """A Sun raster file: ``pixels`` [h, w] (1 or 8 bits: indices or
    bits) or [h, w, 3 or 4] (24 or 32 bits, in file order: BGR or XBGR,
    RGB or XRGB for RT_FORMAT_RGB), rows padded to 16 bits, byte-encoded
    for RT_BYTE_ENCODED; ``colormap`` [3, n] (the red, green and blue
    planes) with maptype 1 (RMT_EQUAL_RGB)."""
    px = np.asarray(pixels, np.uint8)
    h, w = px.shape[:2]
    if bpp == 1:
        rows = np.packbits(px, axis=1)
    else:
        rows = px.reshape(h, -1)
    if rows.shape[1] % 2:
        rows = np.concatenate([rows, np.zeros((h, 1), np.uint8)], 1)
    body = rows.tobytes()
    if kind == RT_BYTE_ENCODED:
        body = sun_rle(body)
    cmap = b"" if colormap is None else np.asarray(colormap,
                                                   np.uint8).tobytes()
    if maptype is None:
        maptype = 1 if cmap else 0
    return struct.pack(">8I", 0x59A66A95, w, h, bpp,
                       len(body) if length is None else length, kind,
                       maptype, len(cmap)) + cmap + body


# ---------------------------------------------------------------------------
# Radiance HDR

def hdr_rle_scanline(rgbe) -> bytes:
    """One new-style RLE scanline: 2, 2, the width, then each of the four
    channels as runs (128 + n, byte) of 3-127 and literals (n, bytes) of
    1-128."""
    rgbe = np.asarray(rgbe, np.uint8)
    w = len(rgbe)
    out = bytearray([2, 2, w >> 8, w & 0xFF])
    for c in range(4):
        v, i = rgbe[:, c].tobytes(), 0
        while i < w:
            run = 1
            while i + run < w and run < 127 and v[i + run] == v[i]:
                run += 1
            if run >= 3:
                out += bytes([128 + run, v[i]])
                i += run
                continue
            j = i
            while j < w and j - i < 128 and not (
                    j + 2 < w and v[j] == v[j + 1] == v[j + 2]):
                j += 1
            out += bytes([j - i]) + v[i:j]
            i = j
    return bytes(out)


def hdr_bytes(rgbe, rle: bool = True, header: bytes = None,
              resolution: bytes = None) -> bytes:
    """A Radiance HDR file of RGBE pixels [h, w, 4]: the header (default
    ``#?RADIANCE``, ``FORMAT=32-bit_rle_rgbe`` and a blank line), the
    resolution line (default ``-Y h +X w``), then new-style RLE scanlines
    or flat pixels."""
    rgbe = np.asarray(rgbe, np.uint8)
    h, w = rgbe.shape[:2]
    if header is None:
        header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
    if resolution is None:
        resolution = f"-Y {h} +X {w}\n".encode()
    body = b"".join(hdr_rle_scanline(r) for r in rgbe) if rle \
        else rgbe.tobytes()
    return header + resolution + body


def jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_bytes(codestream: bytes, ncomp: int, h: int, w: int,
              enumcs: int = 16, colr: bytes = None, pclr=None, cmap=None,
              cdef=None) -> bytes:
    """A JP2 file around a J2K codestream: the signature, ftyp, jp2h (ihdr,
    colr with the enumerated colour space ``enumcs`` or the raw ``colr``
    body, no colr with both None, then pclr, cmap and cdef when given)
    and jp2c.  ``pclr`` is (bits per column, entries [n, columns]),
    ``cmap`` [(component, mtyp, pcol), ...], ``cdef`` [(channel, type,
    association), ...]."""
    hdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, ncomp, 7, 7, 0, 0))
    if colr is None and enumcs is not None:
        colr = b"\x01\x00\x00" + struct.pack(">I", enumcs)
    if colr is not None:
        hdr += jp2_box(b"colr", colr)
    if pclr is not None:
        bits, entries = pclr
        entries = np.asarray(entries, np.int64)
        body = struct.pack(">HB", len(entries), len(bits)) + bytes(
            b - 1 for b in bits)
        for row in entries:
            body += b"".join(int(v).to_bytes((b + 7) // 8, "big")
                             for b, v in zip(bits, row))
        hdr += jp2_box(b"pclr", body)
    if cmap is not None:
        hdr += jp2_box(b"cmap", b"".join(struct.pack(">HBB", *m)
                                         for m in cmap))
    if cdef is not None:
        hdr += jp2_box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *d) for d in cdef))
    return (jp2_box(b"jP  ", b"\r\n\x87\n")
            + jp2_box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + jp2_box(b"jp2h", hdr) + jp2_box(b"jp2c", codestream))


def heif_box(kind: bytes, body: bytes, version=None, flags: int = 0) -> bytes:
    """A box, a full box when ``version`` is given."""
    if version is not None:
        body = struct.pack(">I", version << 24 | flags) + body
    return struct.pack(">I", 8 + len(body)) + kind + body


def _uint(v: int, n: int) -> bytes:
    return v.to_bytes(n, "big") if n else b""


def avif_bytes(obus: bytes, w: int, h: int, av1c: bytes,
               nclx=(1, 13, 6, 1), major: bytes = b"avif",
               brands=(b"avif", b"mif1", b"miaf"), iloc_version: int = 0,
               sizes=(4, 4, 0, 0), idat: bool = False, extents: int = 1,
               ipma_large: bool = False, ipma_version: int = 0,
               infe_version: int = 2, item_id: int = 1, hidden: bool = False,
               pixi=(8, 8, 8), extra_props=(), alpha=None,
               iref_extra=()) -> bytes:
    """An AVIF file of one av01 item holding ``obus``: ftyp, meta (hdlr,
    pitm, iloc, iinf, iref, iprp with ipco / ipma, idat) and mdat.

    ``av1c`` is the av1C body; ``nclx`` (primaries, transfer, matrix,
    full range) the colr box, or None for none; ``sizes`` iloc's offset,
    length, base offset and index sizes in bytes; ``idat`` stores the
    item in an idat box (construction method 1, iloc version 1 or 2);
    ``extents`` splits it into that many extents, laid out in reverse;
    ``ipma_large`` writes 15-bit property indices; ``hidden`` sets the
    item's hidden flag; ``pixi`` its bit depths or None; ``extra_props``
    more (box, essential) properties of the item; ``alpha`` an
    (obus, av1c) alpha item, linked by auxl (its pixi the av1C's depth);
    ``iref_extra`` more (type, from, to) references (a prem reference
    from item 1 to 2 marks the alpha premultiplied)."""
    items = [(item_id, obus, av1c, nclx, pixi, extra_props)]
    alpha_id = item_id + 1
    if alpha is not None:
        urn = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
        depth = 12 if alpha[1][2] & 0x20 else 10 if alpha[1][2] & 0x40 else 8
        items.append((alpha_id, alpha[0], alpha[1], None, (depth,),
                      ((heif_box(b"auxC", urn, 0), False),)))
    off_size, len_size, base_size, index_size = sizes
    props, assoc = [], {}
    for iid, _, config, colr, depths, extra in items:
        own = [(heif_box(b"ispe", struct.pack(">II", w, h), 0), False)]
        if depths is not None:
            own.append((heif_box(b"pixi", bytes([len(depths), *depths]), 0),
                        False))
        own.append((heif_box(b"av1C", config), True))
        if colr is not None:
            p, t, m, full = colr
            own.append((heif_box(b"colr", b"nclx" + struct.pack(
                ">HHHB", p, t, m, full << 7)), False))
        own.extend(extra)
        assoc[iid] = []
        for box, essential in own:
            props.append(box)
            assoc[iid].append((len(props), essential))
    ipma = struct.pack(">I", len(assoc))
    for iid, entries in assoc.items():
        ipma += _uint(iid, 2 if ipma_version == 0 else 4)
        ipma += bytes([len(entries)])
        for index, essential in entries:
            ipma += (struct.pack(">H", essential << 15 | index) if ipma_large
                     else bytes([essential << 7 | index]))
    iprp = heif_box(b"iprp", heif_box(b"ipco", b"".join(props))
                    + heif_box(b"ipma", ipma, ipma_version,
                               1 if ipma_large else 0))
    infes = b""
    for iid, *_ in items:
        kind = b"av01"
        name = b"Color\0" if iid == item_id else b"Alpha\0"
        flags = 1 if hidden and iid == item_id else 0
        infes += heif_box(b"infe", _uint(iid, 2 if infe_version == 2 else 4)
                          + b"\0\0" + kind + name, infe_version, flags)
    iinf = heif_box(b"iinf", struct.pack(">H", len(items)) + infes, 0)
    refs = list(iref_extra)
    if alpha is not None:
        refs.append((b"auxl", alpha_id, item_id))
    iref = heif_box(b"iref", b"".join(
        heif_box(k, struct.pack(">HHH", a, 1, b)) for k, a, b in refs),
        0) if refs else b""

    def layout(data_start):
        pieces, payload, pos = [], b"", data_start
        for iid, stream, *_ in items:
            cut = [len(stream) * k // extents for k in range(extents + 1)]
            parts = [stream[cut[k]:cut[k + 1]] for k in range(extents)]
            offsets = {}
            for k in reversed(range(extents)):      # stored in reverse
                offsets[k] = pos
                payload += parts[k]
                pos += len(parts[k])
            pieces.append((iid, [(offsets[k], len(parts[k]))
                                 for k in range(extents)]))
        return pieces, payload

    def iloc_box(pieces, base):
        body = struct.pack(">BB", off_size << 4 | len_size,
                           base_size << 4 | (index_size if iloc_version
                                             else 0))
        body += _uint(len(pieces), 2 if iloc_version < 2 else 4)
        for iid, ext in pieces:
            body += _uint(iid, 2 if iloc_version < 2 else 4)
            if iloc_version:
                body += struct.pack(">H", 1 if idat else 0)
            body += b"\0\0" + _uint(base, base_size)
            body += struct.pack(">H", len(ext))
            for k, (offset, length) in enumerate(ext):
                if iloc_version and index_size:
                    body += _uint(k, index_size)
                body += _uint(offset - base, off_size) + _uint(length,
                                                               len_size)
        return heif_box(b"iloc", body, iloc_version)

    ftyp = heif_box(b"ftyp", major + b"\0\0\0\0" + b"".join(brands))
    hdlr = heif_box(b"hdlr", b"\0" * 4 + b"pict" + b"\0" * 12 + b"\0", 0)
    pitm = heif_box(b"pitm", struct.pack(">H", item_id), 0)
    base = 8 if base_size else 0

    def meta_of(pieces, payload):
        tail = heif_box(b"idat", payload) if idat else b""
        return heif_box(b"meta", hdlr + pitm + iloc_box(pieces, base) + iinf
                        + iref + iprp + tail, 0)

    if idat:
        return ftyp + meta_of(*layout(base))
    size = len(meta_of(*layout(base)))        # offsets do not change it
    pieces, payload = layout(len(ftyp) + size + 8)
    return ftyp + meta_of(pieces, payload) + heif_box(b"mdat", payload)


def avif_grid_bytes(tiles, w: int, h: int, av1c: bytes, rows: int,
                    cols: int, output=None, body: bytes = None, ispe=None,
                    tile_av1c=None, tile_ispe=None,
                    tile_kind: bytes = b"av01", depth: int = 8,
                    alpha=None, iref_extra=()) -> bytes:
    """An AVIF whose primary item is a rows x cols grid (in idat) of w x h
    av01 tiles, the AV1 streams ``tiles`` in raster order (as many as
    given: a count unlike rows x cols makes a grid libavif refuses), the
    grid's colr BT.601 full range.  ``output`` the grid's (width,
    height), by default the tiles' cover (32-bit fields past 65535);
    ``body`` an ImageGrid body in its place; ``ispe`` the grid's ispe,
    by default the output; ``tile_av1c`` an av1C body for each tile in
    place of ``av1c``; ``tile_ispe`` a (width, height) or None (no ispe)
    for each tile in place of (w, h); ``tile_kind`` the tiles' item
    type; ``depth`` the bit depth the grid's pixi gives; ``alpha`` an
    (obus, av1c) alpha item for each tile, linked to it by auxl (items
    n + 2.., after the tiles in iloc: libavif assembles them into an
    alpha grid, item 2n + 2); ``iref_extra`` more (type, from, to)
    references (prem from the grid, n + 1, to 2n + 2 marks that alpha
    grid premultiplied)."""
    streams = list(tiles)
    n = len(streams)
    grid_id = n + 1
    alpha = list(alpha or ())
    out_w, out_h = output or (w * cols, h * rows)
    props = [heif_box(b"pixi", bytes([3, depth, depth, depth]), 0),
             heif_box(b"colr", b"nclx" + struct.pack(">HHHB", 1, 13, 6, 128)),
             heif_box(b"ispe", struct.pack(">II", *(ispe or (out_w, out_h))),
                      0)]
    ipma = struct.pack(">I", n + 1)
    for iid, config, size in zip(range(1, n + 1), tile_av1c or [av1c] * n,
                                 tile_ispe or [(w, h)] * n):
        own = [(heif_box(b"av1C", config), 0x80)]
        if size is not None:
            own.append((heif_box(b"ispe", struct.pack(">II", *size), 0), 0))
        index = []
        for box, essential in own:         # each distinct box once
            if box not in props:
                props.append(box)
            index.append(essential | props.index(box) + 1)
        ipma += struct.pack(">HB", iid, len(index) + 2) + bytes(index + [1, 2])
    ipma += struct.pack(">HB", grid_id, 3) + bytes([3, 1, 2])
    urn = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
    for k, (_, config) in enumerate(alpha):
        a_depth = 12 if config[2] & 0x20 else 10 if config[2] & 0x40 else 8
        own = [(heif_box(b"auxC", urn, 0), 0),
               (heif_box(b"av1C", config), 0x80),
               (heif_box(b"ispe", struct.pack(">II", w, h), 0), 0),
               (heif_box(b"pixi", bytes([1, a_depth]), 0), 0)]
        index = []
        for box, essential in own:
            if box not in props:
                props.append(box)
            index.append(essential | props.index(box) + 1)
        ipma += struct.pack(">HB", grid_id + 1 + k, len(index)) + bytes(index)
    ipma = struct.pack(">I", n + 1 + len(alpha)) + ipma[4:]
    iprp = heif_box(b"iprp", heif_box(b"ipco", b"".join(props))
                    + heif_box(b"ipma", ipma, 0))
    infes = b"".join(heif_box(b"infe", struct.pack(">HH", iid, 0) + tile_kind
                              + b"\0", 2, 1) for iid in range(1, n + 1))
    infes += heif_box(b"infe", struct.pack(">HH", grid_id, 0) + b"grid\0",
                      2)
    infes += b"".join(heif_box(b"infe", struct.pack(
        ">HH", grid_id + 1 + k, 0) + b"av01Alpha\0", 2, 1)
        for k in range(len(alpha)))
    iinf = heif_box(b"iinf", struct.pack(">H", n + 1 + len(alpha)) + infes,
                    0)
    refs = b"".join(heif_box(b"auxl", struct.pack(">HHH", grid_id + 1 + k,
                                                  1, k + 1))
                    for k in range(len(alpha)))
    refs += b"".join(heif_box(kind, struct.pack(">HHH", a, 1, b))
                     for kind, a, b in iref_extra)
    iref = heif_box(b"iref", heif_box(b"dimg", struct.pack(
        ">HH", grid_id, n) + b"".join(struct.pack(">H", i)
                                      for i in range(1, n + 1))) + refs, 0)
    if body is None:
        wide = max(out_w, out_h) > 0xFFFF
        body = bytes([0, int(wide), rows - 1, cols - 1]) + struct.pack(
            ">II" if wide else ">HH", out_w, out_h)
    ftyp = heif_box(b"ftyp", b"avif\0\0\0\0avifmif1miaf")
    hdlr = heif_box(b"hdlr", b"\0" * 4 + b"pict" + b"\0" * 13, 0)
    pitm = heif_box(b"pitm", struct.pack(">H", grid_id), 0)

    def meta(start):        # the tiles in mdat, the grid in idat
        loc = struct.pack(">BBH", 0x44, 0, n + 1 + len(alpha))
        for iid, stream in list(enumerate(streams, 1)) + [
                (grid_id + 1 + k, a[0]) for k, a in enumerate(alpha)]:
            loc += struct.pack(">HHHHII", iid, 0, 0, 1, start, len(stream))
            start += len(stream)
        loc += struct.pack(">HHHHII", grid_id, 1, 0, 1, 0, len(body))
        return heif_box(b"meta", hdlr + pitm + heif_box(b"iloc", loc, 1)
                        + iinf + iref + iprp + heif_box(b"idat", body), 0)

    start = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(start) + heif_box(b"mdat", b"".join(
        streams + [a[0] for a in alpha]))


# libaom 3.6's aom_codec_enc_cfg_t as unsigned ints: the fields the
# encoder below sets, and default values it checks (the library's layout)
_AOM_CFG = {"g_profile": 2, "g_w": 3, "g_h": 4, "g_limit": 5,
            "g_bit_depth": 8, "g_input_bit_depth": 9, "g_lag_in_frames": 14,
            "rc_resize_mode": 16, "rc_resize_denominator": 17,
            "rc_superres_mode": 19, "rc_superres_denominator": 20,
            "rc_superres_kf_denominator": 21, "rc_end_usage": 24,
            "monochrome": 52}
_AOM_CFG_DEFAULTS = {3: 320, 4: 240, 8: 8, 9: 8, 20: 8, 21: 8, 34: 256,
                     36: 63, 48: 9999}
AOM_ENCODER_ABI = 25        # AOM_ENCODER_ABI_VERSION of libaom 3.6
# the subsamplings as aom_img_fmt_t and the profile each needs at 8 or
# 10 bits (12 bits need profile 2 at every subsampling)
_AOM_FORMATS = {"4:2:0": (0x102, 0), "4:0:0": (0x102, 0),
                "4:4:4": (0x106, 1), "4:2:2": (0x105, 2)}


def _aom_profile(subsampling: str, bit_depth: int) -> int:
    return 2 if bit_depth == 12 else _AOM_FORMATS[subsampling][1]


def aom_encode(planes, subsampling: str = "4:2:0", superres=None,
               options=None, lib=None, bit_depth: int = 8, usage: int = 0,
               layers=None, sequence=None, lag: int = 0,
               resize=None, flags=None) -> bytes:
    """One key frame of ``planes`` ([Y, U, V] at the subsampling's sizes,
    or [Y] for 4:0:0; uint8, or samples below 2**bit_depth for 10 or 12
    bits) through the system libaom.so.3 (3.6, found as
    ``tools/av1_tables.py`` finds it unless ``lib`` names it) by ctypes:
    its OBUs.  Good-quality usage at a constant quantizer (``options``
    take aom_codec_set_option's keys: ``cq-level``, ``cpu-used``,
    ``enable-restoration``, ``tile-columns``, ``sb-size``,
    ``film-grain-test``; ``tune-content`` "screen" with
    ``enable-palette`` and ``enable-intrabc`` for palettes and intra
    block copy, ...); ``superres`` a denominator 9..16 of fixed superres
    (rc_superres_mode 1), which no key reaches; ``bit_depth`` above 8
    through libaom's high-bitdepth route; ``usage`` 0 good quality or 1
    realtime.  ``layers`` encodes spatial layers in one temporal unit
    (AOME_SET_NUMBER_SPATIAL_LAYERS, lag 0): a list of dicts, one a
    layer, whose ``planes`` (default ``planes``) go through
    AOME_SET_SPATIAL_LAYER_ID, ``cq_level`` AOME_SET_CQ_LEVEL, ``scale``
    an (h, v) AOME_SET_SCALEMODE pair (0 normal, 6 one half, ...) and
    ``flags`` the AOM_EFLAG bits of its aom_codec_encode; the base layer
    is forced to a key frame.  ``sequence`` encodes those planes as the
    following frames, one a temporal unit, ``lag`` frames ahead (hidden
    alt-ref frames, compound prediction and frames shown again): one
    item's data holding them all; ``resize`` a (mode, denominator) of
    libaom's frame resizing (rc_resize_mode 1: every frame but the key
    frame coded at 8/denominator of the size, predicted from scaled
    references); ``flags`` the AOM_EFLAG bits of each frame's
    aom_codec_encode, the first frame's first (``AOM_EFLAG_ERROR_RESILIENT``
    an error-resilient frame without the sequence's frame ids).
    RuntimeError where the library is not libaom 3.6's layout."""
    import ctypes
    from objectdetectionpl_tpu_torch.tools.av1_tables import find_libaom
    path = lib or find_libaom()
    if path is None:
        raise RuntimeError("libaom.so.3 is not in the dynamic linker's cache")
    aom = ctypes.CDLL(path)
    vp, cp = ctypes.c_void_p, ctypes.c_char_p
    aom.aom_codec_av1_cx.restype = vp
    aom.aom_codec_enc_config_default.argtypes = [vp, vp, ctypes.c_uint]
    aom.aom_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    aom.aom_codec_set_option.argtypes = [vp, cp, cp]
    aom.aom_img_wrap.argtypes = [vp, ctypes.c_int, ctypes.c_uint,
                                 ctypes.c_uint, ctypes.c_uint, vp]
    aom.aom_img_wrap.restype = vp
    aom.aom_codec_encode.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_ulong,
                                     ctypes.c_long]
    aom.aom_codec_get_cx_data.argtypes = [vp, vp]
    aom.aom_codec_get_cx_data.restype = vp
    aom.aom_codec_destroy.argtypes = [vp]
    aom.aom_codec_control.argtypes = [vp, ctypes.c_int]
    layered = layers is not None
    if planes is None:
        planes = layers[0]["planes"]
    h, w = planes[0].shape
    fmt = _AOM_FORMATS[subsampling][0]
    profile = _aom_profile(subsampling, bit_depth)
    sx = int(subsampling in ("4:2:0", "4:0:0", "4:2:2"))
    sy = int(subsampling in ("4:2:0", "4:0:0"))
    cfg = (ctypes.c_uint32 * 1024)()
    iface = aom.aom_codec_av1_cx()
    if aom.aom_codec_enc_config_default(iface, cfg, usage) or any(
            cfg[k] != v for k, v in _AOM_CFG_DEFAULTS.items()):
        raise RuntimeError(f"{path}: not libaom 3.6's encoder config")
    set_cfg = {"g_profile": profile, "g_w": w, "g_h": h,
               "g_limit": len(layers) if layered
               else 1 + len(sequence or ()),
               "rc_end_usage": 3, "monochrome": int(subsampling == "4:0:0"),
               "g_bit_depth": bit_depth, "g_input_bit_depth": bit_depth}
    if layered or sequence:
        set_cfg["g_lag_in_frames"] = lag if sequence else 0
    if resize is not None:
        set_cfg.update(rc_resize_mode=resize[0],
                       rc_resize_denominator=resize[1])
    if superres is not None:
        set_cfg.update(rc_superres_mode=1, rc_superres_denominator=superres,
                       rc_superres_kf_denominator=superres)
    for k, v in set_cfg.items():
        cfg[_AOM_CFG[k]] = v
    ctx = ctypes.create_string_buffer(1024)
    high = bit_depth > 8        # AOM_CODEC_USE_HIGHBITDEPTH
    if aom.aom_codec_enc_init_ver(ctx, iface, cfg, 0x40000 if high else 0,
                                  AOM_ENCODER_ABI):
        raise RuntimeError(f"{path}: aom_codec_enc_init_ver failed")
    try:
        for k, v in (options or {}).items():
            if aom.aom_codec_set_option(ctx, k.encode(), str(v).encode()):
                raise RuntimeError(f"libaom refuses the option {k}={v}")

        def control(ctrl, value):
            arg = value if isinstance(value, ctypes.Array) else \
                ctypes.c_int(value)
            if aom.aom_codec_control(ctx, ctrl, arg):
                raise RuntimeError(f"libaom refuses control {ctrl}={value}")

        def wrap(planes):
            # aom_img_wrap's layout: luma padded to the subsampling's
            # multiple (align_image_dimension), then each chroma plane
            aw, ah = (w + sx) >> sx << sx, (h + sy) >> sy << sy
            dtype = np.uint16 if high else np.uint8
            pieces = [np.zeros((ah, aw), dtype)]
            pieces[0][:h, :w] = planes[0]
            for c in range(2):
                q = np.full((ah >> sy, aw >> sx), 1 << (bit_depth - 1), dtype)
                if len(planes) > 1:
                    q[:planes[1 + c].shape[0], :planes[1 + c].shape[1]] = \
                        planes[1 + c]
                pieces.append(q)
            buf = np.concatenate([q.reshape(-1) for q in pieces])
            img = ctypes.create_string_buffer(512)
            if not aom.aom_img_wrap(img, fmt | (0x800 if high else 0), w, h,
                                    1, buf.ctypes.data):
                raise RuntimeError("aom_img_wrap failed")
            return img, buf

        # a key frame (forced, but for a sequence's first)
        frames = [(wrap(planes), 0 if sequence else 1, None)]
        frames += [(wrap(p), 0, None) for p in sequence or ()]
        frames = [(img, f | extra, layer) for (img, f, layer), extra in
                  zip(frames, list(flags or ()) + [0] * len(frames))]
        if layered:
            control(27, len(layers))          # AOME_SET_NUMBER_SPATIAL_LAYERS
            frames = [(wrap(lay.get("planes", planes)),
                       lay.get("flags", 0) | (1 if i == 0 else 0), (i, lay))
                      for i, lay in enumerate(layers)]
        out = b""
        pts = 0
        # the frames, then flushes until the encoder has nothing left
        for image, flags, layer in frames + [((None, None), 0, None)] * 99:
            if layer is not None:
                i, lay = layer
                control(12, i)                # AOME_SET_SPATIAL_LAYER_ID
                if "cq_level" in lay:
                    control(25, lay["cq_level"])      # AOME_SET_CQ_LEVEL
                control(11, (ctypes.c_int * 2)(*lay.get("scale", (0, 0))))
            if aom.aom_codec_encode(ctx, image[0], pts, 1, flags):
                raise RuntimeError("aom_codec_encode failed")
            pts += bool(sequence)
            it = ctypes.c_void_p(0)
            got = False
            while True:
                pkt = aom.aom_codec_get_cx_data(ctx, ctypes.byref(it))
                if not pkt:
                    break
                if ctypes.c_int.from_address(pkt).value == 0:   # a frame
                    data = ctypes.c_void_p.from_address(pkt + 8).value
                    size = ctypes.c_size_t.from_address(pkt + 16).value
                    out += ctypes.string_at(data, size)
                    got = True
            if image[0] is None and not got:
                break
        return out
    finally:
        aom.aom_codec_destroy(ctx)


AOM_EFLAG_ERROR_RESILIENT = 1 << 28      # aomcx.h


def av1c_bytes(subsampling: str, bit_depth: int = 8) -> bytes:
    """An av1C body for a stream of the subsampling and bit depth (8, 10
    or 12): profile 0, 1 or 2 as ``aom_encode`` writes it (2 at 12
    bits, with the twelve_bit flag), level 31, chroma position 0."""
    profile = _aom_profile(subsampling, bit_depth)
    mono = int(subsampling == "4:0:0")
    sx = int(subsampling in ("4:2:0", "4:0:0", "4:2:2"))
    sy = int(subsampling in ("4:2:0", "4:0:0"))
    return bytes([0x81, profile << 5 | 31, (bit_depth > 8) << 6
                  | (bit_depth == 12) << 5 | mono << 4 | sx << 3 | sy << 2,
                  0])


def _yuv(rgb: np.ndarray, subsampling: str) -> list:
    """BT.601 full-range planes of an RGB image, chroma averaged over each
    subsampled block (edge samples repeated)."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    planes = [y, (b - y) / 1.772 + 128, (r - y) / 1.402 + 128]
    sx = int(subsampling in ("4:2:0", "4:2:2"))
    sy = int(subsampling == "4:2:0")
    out = [np.clip(np.rint(planes[0]), 0, 255).astype(np.uint8)]
    h, w = y.shape
    for c in planes[1:]:
        c = np.pad(c, ((0, h % 2 * sy), (0, w % 2 * sx)), mode="edge")
        c = c.reshape(c.shape[0] >> sy, 1 << sy, c.shape[1] >> sx,
                      1 << sx).mean((1, 3))
        out.append(np.clip(np.rint(c), 0, 255).astype(np.uint8))
    return out


def avif_stage_files() -> Dict[str, bytes]:
    """The committed AVIFs of the stages after CDEF, from crops of the
    500x375 fixture: ``aom_encode``'s 4:2:0 file whose planes take Wiener
    units, Pillow's at speed 2 whose luma and V take self-guided units
    (128x128 superblocks), ``aom_encode``'s superres file (denominator
    16, two tile columns of the 64x288 crop's 144 coded columns,
    self-guided and Wiener units) and Pillow's film-grain-test 1 file.
    Needs Pillow's AVIF plugin and the system libaom."""
    import io

    from PIL import Image

    rgb = native.decode_one(str(TESTDATA / BASE))

    def pillow(img, **kw):
        out = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(img)).save(out, format="AVIF",
                                                        **kw)
        return out.getvalue()

    crop = rgb[100:220, 150:310]
    wide = rgb[140:204, 100:388]
    restoration = {"cpu-used": 4, "sb-size": "64", "enable-restoration": 1}
    return {
        "avif_wiener": avif_bytes(
            aom_encode(_yuv(crop, "4:2:0"), "4:2:0",
                       options={"cq-level": 5, **restoration}),
            160, 120, av1c_bytes("4:2:0")),
        "avif_sgrproj": pillow(crop, speed=2, quality=50, advanced={
            "enable-restoration": "1", "sb-size": "128"}),
        "avif_superres": avif_bytes(
            aom_encode(_yuv(wide, "4:2:0"), "4:2:0", superres=16, options={
                "cq-level": 20, "tile-columns": 1, **restoration}),
            288, 64, av1c_bytes("4:2:0")),
        "avif_film_grain": pillow(crop, quality=60,
                                  advanced={"film-grain-test": "1"}),
    }


def screen_regions(h: int, w: int, seed: int) -> np.ndarray:
    """Screen content for palettes: 32x32 regions, each of 2 to 8
    colours laid out in 4x4 squares (RGB uint8)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    for y in range(0, h, 32):
        for x in range(0, w, 32):
            k = int(rng.integers(2, 9))
            colours = rng.integers(0, 256, (k, 3))
            lab = rng.integers(0, k, (8, 8)).repeat(4, 0).repeat(4, 1)
            part = img[y:y + 32, x:x + 32]
            part[:] = colours[lab][:part.shape[0], :part.shape[1]]
    return img


def screen_text(h: int, w: int, seed: int) -> np.ndarray:
    """Screen content for intra block copy: a page of ten 7x10 glyphs
    drawn in one colour on another (RGB uint8)."""
    rng = np.random.default_rng(seed)
    glyphs = rng.integers(0, 2, (10, 10, 7)).astype(bool)
    fg, bg = rng.integers(0, 256, (2, 3))
    img = np.empty((h, w, 3), np.uint8)
    img[:] = bg
    for y in range(1, h - 10, 12):
        for x in range(1, w - 7, 8):
            img[y:y + 10, x:x + 7][glyphs[rng.integers(10)]] = fg
    return img


def avif_screen_files() -> Dict[str, bytes]:
    """The committed AVIFs of screen content, from ``aom_encode`` with
    libaom's screen tuning: palettes in 4:4:4 (Y and UV, 2 to 8 colours)
    and in 4:2:0 at 157x117 over 128x128 superblocks, intra block copy in
    a 4:2:0 page of text, and a 2x2 grid of 64x64 4:2:0 tiles (crops of
    the 500x375 fixture) cropped to 120x100.  Needs the system libaom."""
    screen = {"tune-content": "screen", "cpu-used": 4}

    def encode(rgb, sub, **options):
        h, w = rgb.shape[:2]
        return avif_bytes(aom_encode(_yuv(rgb, sub), sub,
                                     options={**screen, **options}),
                          w, h, av1c_bytes(sub))

    rgb = native.decode_one(str(TESTDATA / BASE))
    tiles = [aom_encode(_yuv(rgb[y:y + 64, x:x + 64], "4:2:0"), "4:2:0",
                        options={"cq-level": 30, "cpu-used": 4})
             for y, x in ((100, 150), (100, 214), (164, 150), (164, 214))]
    return {
        "avif_palette_444": encode(screen_regions(120, 160, 1), "4:4:4",
                                   **{"cq-level": 20, "enable-intrabc": 0}),
        "avif_palette_420": encode(screen_regions(117, 157, 2), "4:2:0",
                                   **{"cq-level": 20, "enable-intrabc": 0,
                                      "sb-size": "128"}),
        "avif_intrabc": encode(screen_text(120, 160, 3), "4:2:0",
                               **{"cq-level": 40, "enable-palette": 0}),
        "avif_grid_cropped": avif_grid_bytes(
            tiles, 64, 64, av1c_bytes("4:2:0"), 2, 2, output=(120, 100)),
    }


def deepen(planes, depth: int) -> list:
    """8-bit planes at ``depth`` bits, each level's high bits replicated
    below it (255 -> 1023 or 4095)."""
    s = depth - 8
    return [(p.astype(np.uint16) << s) | (p.astype(np.uint16) >> (8 - s))
            for p in planes]


def avif_depth_files() -> Dict[str, bytes]:
    """The committed AVIFs of 10 and 12 bits, image sequences and
    premultiplied alpha, from crops of the 500x375 fixture: ``aom_encode``
    at 10 bits in 4:2:0, 4:4:4 with Wiener / self-guided units, 4:2:0
    with film-grain-test 1, 4:0:0, and screen content (a page of glyphs,
    4:4:4, palettes and intra block copy); at 12 bits in 4:2:2; Pillow's
    three-frame sequence whose meta item is pointed at the second sample
    (cv2 reads the track's first), its times of creation and
    modification zeroed; a 10-bit 4:2:0 image with a 10-bit
    limited-range alpha item (opaque, transparent and graded regions)
    and a prem reference.  Needs Pillow's AVIF plugin and the system
    libaom."""
    import io

    from PIL import Image

    rgb = native.decode_one(str(TESTDATA / BASE))
    crop = rgb[100:220, 150:310]

    def encode(img, sub, depth=10, **options):
        h, w = img.shape[:2]
        planes = _yuv(img, "4:2:0" if sub == "4:0:0" else sub)
        planes = deepen(planes[:1] if sub == "4:0:0" else planes, depth)
        obus = aom_encode(planes, sub, bit_depth=depth,
                          options={"cpu-used": 4, **options})
        return obus, avif_bytes(obus, w, h, av1c_bytes(sub, depth),
                                pixi=(depth,) * (1 if sub == "4:0:0" else 3))

    frames = [Image.fromarray(np.ascontiguousarray(rgb[100 + 20 * k:
                                                       220 + 20 * k,
                                                       150:310]))
              for k in range(3)]
    out = io.BytesIO()
    frames[0].save(out, format="AVIF", save_all=True,
                   append_images=frames[1:], duration=100, quality=60)
    sequence = bytearray(out.getvalue())
    stco, stsz = sequence.index(b"stco") + 12, sequence.index(b"stsz") + 16
    first = struct.unpack(">I", sequence[stco:stco + 4])[0]
    size = struct.unpack(">I", sequence[stsz:stsz + 4])[0]
    at = sequence.index(struct.pack(">I", first), sequence.index(b"iloc"))
    sequence[at:at + 8] = struct.pack(">I", first + size) + \
        sequence[stsz + 4:stsz + 8]
    for kind in (b"mvhd", b"tkhd", b"mdhd"):    # creation, modification
        box = sequence.index(kind) + 4
        n = 8 if sequence[box] else 4
        sequence[box + 4:box + 4 + 2 * n] = bytes(2 * n)
    colour, _ = encode(crop, "4:2:0", **{"cq-level": 15})
    y, x = np.mgrid[0:120, 0:160]
    alpha = np.clip((x - 40) * 1023 // 80, 0, 1023).astype(np.uint16)
    alpha[:40] = 1023
    alpha[80:, :80] = 0
    prem_alpha = aom_encode([alpha], "4:0:0", bit_depth=10,
                            options={"cq-level": 10, "cpu-used": 4})
    return {
        "avif_10bit_420": encode(crop, "4:2:0", **{"cq-level": 15})[1],
        "avif_10bit_444_lr": encode(crop, "4:4:4", **{
            "cq-level": 5, "enable-restoration": 1, "sb-size": "64"})[1],
        "avif_10bit_film_grain": encode(crop, "4:2:0", **{
            "cq-level": 30, "film-grain-test": 1})[1],
        "avif_12bit_422": encode(crop, "4:2:2", 12, **{"cq-level": 15})[1],
        "avif_10bit_400": encode(crop, "4:0:0", **{"cq-level": 15})[1],
        "avif_10bit_screen": encode(screen_text(120, 160, 3), "4:4:4", **{
            "cq-level": 30, "tune-content": "screen", "enable-palette": 1,
            "enable-intrabc": 1})[1],
        "avif_sequence": bytes(sequence),
        "avif_prem": avif_bytes(colour, 160, 120, av1c_bytes("4:2:0", 10),
                                pixi=(10,) * 3,
                                alpha=(prem_alpha, av1c_bytes("4:0:0", 10)),
                                iref_extra=((b"prem", 1, 2),)),
    }


def av1_obus(stream: bytes) -> list:
    """The OBUs of an AV1 stream (each with its size field): (type, the
    OBU's bytes, its payload)."""
    out, i = [], 0
    while i < len(stream):
        start, kind, ext = i, stream[i] >> 3 & 15, stream[i] >> 2 & 1
        i += 1 + ext
        size = shift = 0
        while True:
            b = stream[i]
            i += 1
            size |= (b & 127) << shift
            shift += 7
            if not b & 128:
                break
        out.append((kind, stream[start:i + size], stream[i:i + size]))
        i += size
    return out


def _bits(data: bytes) -> list:
    return [(x >> (7 - i)) & 1 for x in data for i in range(8)]


def _put(v: int, n: int) -> list:
    return [(v >> (n - 1 - i)) & 1 for i in range(n)]


def _leb128(v: int) -> bytes:
    out = b""
    while True:
        out += bytes([(v & 127) | (128 if v >> 7 else 0)])
        v >>= 7
        if not v:
            return out


def _bytes_of(bits: list) -> bytes:
    bits = bits + [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[k:k + 8])), 2)
                 for k in range(0, len(bits), 8))


def with_operating_points(stream: bytes, points) -> bytes:
    """The stream with each sequence header (full, no timing info) given
    the operating points ``points`` ((operating_point_idc,
    seq_level_idx), ...)."""
    out = b""
    for kind, raw, body in av1_obus(stream):
        if kind != 1:
            out += raw
            continue
        bits = _bits(body)
        assert bits[4] == 0 and bits[5] == 0    # not reduced, no timing
        delay, count, pos = bits[6], int("".join(map(str, bits[7:12])), 2) + 1, 12
        for _ in range(count):
            level = int("".join(map(str, bits[pos + 12:pos + 17])), 2)
            pos += 17 + (level > 7)
            if delay:
                pos += 5 if bits[pos] else 1
        end = len(bits) - 1 - bits[::-1].index(1)     # the trailing 1 bit
        new = bits[:6] + [0] + _put(len(points) - 1, 5)
        for idc, level in points:
            new += _put(idc, 12) + _put(level, 5) + [0] * (level > 7)
        payload = _bytes_of(new + bits[pos:end] + [1])
        out += bytes([0x0A, len(payload)]) + payload
    return out


def _subexp_with_ref(x: int, mx: int, ref: int) -> list:
    """The bits of the AV1 specification's decode_signed_subexp_with_ref
    (low -mx, high mx + 1, reference ``ref``) reading ``x``: the
    recentring against the reference, then decode_subexp's classes."""
    num, v, r = 2 * mx + 1, x + mx, ref + mx

    def recenter(r, v):
        return v if v > 2 * r else 2 * (v - r) if v >= r else 2 * (r - v) - 1

    v = recenter(r, v) if 2 * r <= num else recenter(num - 1 - r,
                                                     num - 1 - v)
    bits, i, mk = [], 0, 0
    while True:
        b2 = 3 + i - 1 if i else 3
        a = 1 << b2
        if num <= mk + 3 * a:                 # ns(num - mk)
            n = num - mk
            w = n.bit_length()
            m = (1 << w) - n
            u = v - mk
            if u < m:
                return bits + _put(u, w - 1)
            return bits + _put(m + ((u - m) >> 1), w - 1) + [(u - m) & 1]
        if v >= mk + a:
            bits.append(1)
            i, mk = i + 1, mk + a
        else:
            return bits + [0] + _put(v - mk, b2)


# global motion types and their codes (is_global, is_rot_zoom,
# is_translation)
GM_TYPES = {"identity": [0], "translation": [1, 0, 1], "rotzoom": [1, 1],
            "affine": [1, 0, 0]}


def with_global_motion(stream: bytes, models, frame: int = -1) -> bytes:
    """The stream with one inter frame header's global_motion_params()
    rewritten: ``models`` {reference frame 1..7 (LAST..ALTREF): (type,
    wmmat)}, a type of ``GM_TYPES`` and the model's six parameters at
    WARPEDMODEL_PREC_BITS (16) as the header reads them back (each on
    its type's grid: alpha parameters multiples of 2, translations of
    2**10, or 2**13 / 2**14 for a translation-only model with / without
    high-precision vectors); the others IDENTITY.  ``frame`` indexes
    the inter frame headers (``native.av1_frame_marks``, stream order).
    Each parameter is coded against the default model, the reference
    of a frame whose primary reference frame carries IDENTITY (libaom
    3.6 writes IDENTITY everywhere).  The header's other bits, its film
    grain and the tile data are kept and the OBU's size rewritten;
    later frames keep IDENTITY, so their bits mean what they meant."""
    marks = [m for m in native.av1_frame_marks(stream) if m["gm_start"] >= 0
             and m["frame_type"] in (1, 3)]
    m = marks[frame]
    body = stream[m["payload"]:m["payload"] + m["size"]]
    bits = _bits(body)
    gm = []
    for ref in range(1, 8):
        kind, mat = models.get(ref, ("identity", None))
        gm += GM_TYPES[kind]
        if kind == "identity":
            continue
        order = [2, 3] + ([4, 5] if kind == "affine" else [])
        order = (order if kind != "translation" else []) + [0, 1]
        for idx in order:
            if idx >= 2:
                abs_bits, prec = 12, 15
            elif kind == "translation":
                hp = m["high_precision_mv"]
                abs_bits, prec = 9 - (not hp), 3 - (not hp)
            else:
                abs_bits, prec = 12, 6
            diff = 16 - prec
            one = 1 << 16 if idx in (2, 5) else 0
            if (mat[idx] - one) % (1 << diff):
                raise ValueError(f"wmmat[{idx}] {mat[idx]} is not on its "
                                 "grid")
            x = (mat[idx] - one) >> diff
            if abs(x) > 1 << abs_bits:
                raise ValueError(f"wmmat[{idx}] {mat[idx]} out of range")
            gm += _subexp_with_ref(x, 1 << abs_bits, 0)
    head = bits[:m["gm_start"]] + gm + bits[m["gm_end"]:m["header_end"]]
    if m["obu_type"] == 6:        # a frame OBU: aligned, then the tiles
        payload = _bytes_of(head) + body[(m["header_end"] + 7) // 8:]
    else:                          # a frame header OBU: trailing bits
        payload = _bytes_of(head + [1])
    ext = stream[m["obu"]] >> 2 & 1
    obu = stream[m["obu"]:m["obu"] + 1 + ext] + _leb128(len(payload)) + \
        payload
    return stream[:m["obu"]] + obu + stream[m["payload"] + m["size"]:]


def avif_layer_files() -> Dict[str, bytes]:
    """The committed layered AVIFs, from the 160x120 crop of the 500x375
    fixture through ``aom_encode``'s spatial layers: three key-frame
    layers at cq-levels 50, 30 and 10 (each forced to a key frame: on
    the tree before the port decoded inter frames it returned layer 0
    where cv2 returns layer 2), realtime SVC (layers 1 and 2 inter
    frames predicted from the layer below), good-quality layers at
    cq-levels 50, 30, 10 (local warp among their tools), a realtime base
    layer at half and a second at three quarters of the size (scaled
    references), 10-bit good-quality layers, and the realtime stream with
    two operating points (all layers; the base alone) whose a1op selects
    the second.  Needs the system libaom."""
    rgb = native.decode_one(str(TESTDATA / BASE))
    planes = _yuv(rgb[100:220, 150:310], "4:2:0")

    def encode(layers, usage, depth=8, **options):
        ps = deepen(planes, depth) if depth > 8 else planes
        return aom_encode(None, "4:2:0", usage=usage, bit_depth=depth,
                          layers=[{"planes": ps, **lay} for lay in layers],
                          options={"cpu-used": 4 if usage == 0 else 8,
                                   **options})

    quality = [{"cq_level": q} for q in (50, 30, 10)]
    realtime = encode([{}] * 3, 1)
    two = with_operating_points(realtime, [(0x701, 13), (0x101, 13)])
    a1op = heif_box(b"a1op", bytes([1]))

    def box(obus, depth=8, **kw):
        return avif_bytes(obus, 160, 120, av1c_bytes("4:2:0", depth),
                          pixi=(depth,) * 3, **kw)

    return {
        "avif_layers_key": box(encode([{**q, "flags": 1} for q in quality],
                                      0)),
        "avif_layers_realtime": box(realtime),
        "avif_layers_quality": box(encode(quality, 0)),
        "avif_layers_scaled": box(encode(
            [{"scale": (6, 6)}, {"scale": (3, 3)}, {}], 1)),
        "avif_layers_10bit": box(encode(quality, 0, 10), 10),
        "avif_layers_ops": box(two, extra_props=((a1op, True),)),
    }


def moving_frames(rgb: np.ndarray, n: int, y0: int, x0: int, h: int,
                  w: int, dy: int, dx: int, sub: str = "4:2:0") -> list:
    """n frames' planes (``_yuv``) of h x w crops of ``rgb``, the k-th at
    (y0 + k dy, x0 + k dx)."""
    return [_yuv(rgb[y0 + k * dy:y0 + k * dy + h,
                     x0 + k * dx:x0 + k * dx + w], sub) for k in range(n)]


def mosaic_frames(rgb: np.ndarray, n: int, h: int, w: int, seed: int,
                  tile: int = 16, y0: int = 120, x0: int = 160,
                  sub: str = "4:2:0") -> list:
    """n frames' planes of an h x w mosaic of tile x tile crops of ``rgb``
    from (y0, x0), each tile moving by its own seeded step of up to 4
    samples a frame and two in five standing still: static blocks
    amid moving ones, which libaom codes as GLOBALMV."""
    rng = np.random.default_rng(seed)
    still = rng.random((h // tile, w // tile)) < 0.4
    step = rng.integers(-4, 5, (h // tile, w // tile, 2))
    out = []
    for k in range(n):
        img = np.empty((h, w, 3), np.uint8)
        for i in range(h // tile):
            for j in range(w // tile):
                dy, dx = (0, 0) if still[i, j] else step[i, j] * k
                y, x = y0 + i * tile + dy, x0 + j * tile + dx
                img[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = \
                    rgb[y:y + tile, x:x + tile]
        out.append(_yuv(img, sub))
    return out


def temporal_units(stream: bytes) -> list:
    """The stream's temporal units: each temporal delimiter OBU and the
    OBUs up to the next."""
    units, cur = [], b""
    for kind, raw, _ in av1_obus(stream):
        if kind == 2 and cur:
            units.append(cur)
            cur = b""
        cur += raw
    return units + [cur]


# a rotation and zoom small enough that every block's global vector
# rounds to zero in a 128 x 96 frame (the GLOBALMV blocks warp, the
# candidate lists and so the coded bits keep their meaning); and one
# that moves blocks by up to 1/8 sample (some vectors of one unit)
GM_ROTZOOM = ("rotzoom", [-3072, 0, (1 << 16) + 32, 32, 0, 0])
GM_ROTZOOM_WIDE = ("rotzoom", [-6144, -4096, (1 << 16) + 64, 64, 0, 0])


def avif_inter_files() -> Dict[str, bytes]:
    """The committed AVIFs of the AV1 inter tools libaom 3.6 reaches only
    through frame resizing, a rewritten header, a lost frame or alpha
    tiles, from crops of the 500x375 fixture: a sequence coded at 8/14
    of its key frame's size (compound blocks from the scaled key frame);
    realtime frames of a mosaic whose first inter frame header
    (``with_global_motion``) gives LAST a rotation and zoom (its GLOBALMV
    blocks warp); an error-resilient last frame after a lost temporal
    unit (its LAST slot filled with grey); a 2x2 grid of 10-bit tiles
    with an alpha item on each tile, premultiplied (libavif's alpha
    grid).  Needs the system libaom."""
    rgb = native.decode_one(str(TESTDATA / BASE))
    fr = moving_frames(rgb, 6, 150, 200, 96, 128, 2, 3)
    scaled = aom_encode(fr[0], sequence=fr[1:], lag=5, resize=(1, 14),
                        options={"cpu-used": 0, "cq-level": 30})
    fr = mosaic_frames(rgb, 5, 96, 128, 3)
    mosaic = aom_encode(fr[0], sequence=fr[1:], usage=1, options={
        "cpu-used": 8, "cq-level": 30, "enable-obmc": 0,
        "enable-warped-motion": 0})
    fr = moving_frames(rgb, 5, 150, 200, 96, 128, 2, 3)
    lost = temporal_units(aom_encode(
        fr[0], sequence=fr[1:], flags=[0, 0, 0, 0, AOM_EFLAG_ERROR_RESILIENT],
        options={"cpu-used": 4, "cq-level": 30}))
    tiles, alphas = [], []
    for i in range(4):
        crop = rgb[40 + 64 * (i // 2):104 + 64 * (i // 2),
                   180 + 64 * (i % 2):244 + 64 * (i % 2)]
        tiles.append(aom_encode(deepen(_yuv(crop, "4:2:0"), 10), "4:2:0",
                                bit_depth=10, options={"cq-level": 25,
                                                       "cpu-used": 5}))
        y, x = np.mgrid[0:64, 0:64]
        alpha = ((x * 3 + y * 5 + 97 * i) * 4 % 1024).astype(np.uint16)
        alphas.append((aom_encode([alpha], "4:0:0", bit_depth=10, options={
            "cq-level": 5, "cpu-used": 5}), av1c_bytes("4:0:0", 10)))

    def box(obus, w, h):
        return avif_bytes(obus, w, h, av1c_bytes("4:2:0"))

    return {
        "avif_scaled_compound": box(scaled, 73, 55),
        "avif_global_motion": box(with_global_motion(
            mosaic, {1: GM_ROTZOOM_WIDE}, frame=0), 128, 96),
        "avif_lost_frame": box(b"".join(lost[:3] + lost[4:]), 128, 96),
        "avif_alpha_grid": avif_grid_bytes(
            tiles, 64, 64, av1c_bytes("4:2:0", 10), 2, 2, depth=10,
            alpha=alphas, iref_extra=((b"prem", 5, 10),)),
    }


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
    tiffs.update(tiff_kinds(base, small))
    g3 = COMMITTED["tiff_g3_2d"].read_bytes()
    tiffs["tiff_g3_cut"] = set_tiff_counts(
        g3, [None, _tiff_ifd(g3)[0][279][1] // 2])
    for kind, data in tiffs.items():
        paths[kind] = d / f"{kind}.tiff"
        paths[kind].write_bytes(data)
    # 8-bit colours: 3 bits of red and green, 2 of blue
    index = (rgb[..., 0] & 0xE0) | (rgb[..., 1] >> 5 << 2) | (rgb[..., 2] >> 6)
    cube = np.stack([i & 0xE0, (i >> 2 & 7) * 36, (i & 3) * 85], 1)
    grey = small[..., 1] >> 4
    others = {
        "gif.gif": gif_bytes(w, h, [gif_image(index)], cube, background=9),
        "gif_interlaced_offset.gif": gif_bytes(
            w // 3 + 20, h // 3 + 10, [gif_image(
                grey, left=13, top=6, interlace=True, transparent=5,
                min_code_size=4, palette=np.repeat(
                    np.arange(16)[:, None] * 17, 3, 1))], cube[:16],
            background=2),
        "ppm.ppm": b"P6\n%d %d\n255\n" % (w, h) + rgb.tobytes(),
        "pgm_ascii16.pgm": (b"P2\n# 16-bit\n%d %d\n65535\n"
                            % small.shape[1::-1] + " ".join(map(str, (
                                small[..., 2].astype(np.int64) * 257
                            ).reshape(-1))).encode() + b"\n"),
        "pam.pam": (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\n"
                    b"TUPLTYPE RGB\nENDHDR\n" % small.shape[1::-1]
                    + small.tobytes()),
        "pfm.pfm": (b"PF\n%d %d\n-0.5\n" % small.shape[1::-1]
                    + (small[::-1].astype("<f4") / 2).tobytes()),
        "ras_rgb24.ras": sun_bytes(rgb[..., ::-1], 24),
        "ras_map8.ras": sun_bytes(small[..., 0], 8, colormap=np.stack(
            [i, 255 - i, i * 7 % 256])),
        "hdr.hdr": hdr_bytes(np.dstack([rgb, np.full((h, w), 128,
                                                     np.uint8)])),
    }
    for name, data in others.items():
        kind = name.split(".")[0]
        paths[kind] = d / name
        paths[kind].write_bytes(data)
    paths["jp2_part2"] = d / "jp2_part2.jp2"
    paths["jp2_part2"].write_bytes(jp2_bytes(
        COMMITTED["j2k_part2"].read_bytes(), 3, 120, 160))
    assert sorted(paths) == sorted(KINDS)
    return {k: str(paths[k]) for k in KINDS}


# ---------------------------------------------------------------------------
# Damaged JPEG headers: the committed fixtures patched byte by byte, each
# case as libjpeg-turbo meets it in a scraped tree.

HEADER_HASHES = FORMATS / "headers_sha256.json"   # cv2's decodes, or null
COCO = "coco_420_q75_640x480.jpg"                  # one scan, no restarts


def jpeg_segments(data: bytes):
    """[(marker, start, end)] of a JPEG's marker segments up to its first
    SOS, that SOS's included (``end`` is where its scan data begin)."""
    out, p = [], 2
    while True:
        m = data[p + 1]
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        out.append((m, p, p + 2 + n))
        if m == 0xDA:
            return out
        p += 2 + n


def jpeg_scan_end(data: bytes, sos: int) -> int:
    """Where the scan of the SOS at ``sos`` ends: its first marker that is
    not a stuffed 0xFF00 or a restart marker."""
    q = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    while not (data[q] == 0xFF and data[q + 1] != 0
               and not 0xD0 <= data[q + 1] <= 0xD7):
        q += 1
    return q


def jpeg_restarts(data: bytes, sos: int) -> list:
    """The offsets of the RSTn markers inside the scan at ``sos``."""
    q = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    end = jpeg_scan_end(data, sos)
    return [i for i in range(q, end) if data[i] == 0xFF
            and 0xD0 <= data[i + 1] <= 0xD7]


def _without(data: bytes, drop) -> bytes:
    """``data`` without the header segments for which ``drop(marker,
    segment bytes)`` holds."""
    out, at = bytearray(data[:2]), 2
    for m, s, e in jpeg_segments(data):
        out += data[at:s]
        if not drop(m, data[s:e]):
            out += data[s:e]
        at = e
    return bytes(out + data[at:])


def _at(data: bytes, offset: int, new: bytes, cut: int = 0) -> bytes:
    """``new`` written at ``offset`` in place of ``cut`` bytes."""
    return data[:offset] + new + data[offset + cut:]


def header_cases() -> Dict[str, bytes]:
    """{case: file bytes} of the damaged headers, from the committed
    fixtures: scans whose Huffman tables were never defined (every DHT
    removed, the AC ones removed, a DHT's class or slot changed, an SOS
    naming the empty slot 2), extraneous bytes before markers and around
    restart markers, unknown markers in the header, in the scan, at its
    end and where a restart marker was due, a second SOF, arithmetic
    conditioning tables past 3, and progressions libjpeg warns about."""
    coco = (TESTDATA / COCO).read_bytes()
    rst = (TESTDATA / RESTART).read_bytes()
    prog = (TESTDATA / PROGRESSIVE).read_bytes()
    gray = (TESTDATA / "gray_q85_200x150.jpg").read_bytes()
    opt = (TESTDATA / "optimized_420_q80_320x240.jpg").read_bytes()
    arith = (FORMATS / "arith_progressive_420_q80_160x120.jpg").read_bytes()

    def first(data, marker):
        return next(s for m, s, _ in jpeg_segments(data) if m == marker)

    def dht(data, tc_th):          # the DHT segment holding table tc_th
        return next(s for m, s, _ in jpeg_segments(data)
                    if m == 0xC4 and data[s + 4] == tc_th)

    sos, rsos, psos = first(coco, 0xDA), first(rst, 0xDA), first(prog, 0xDA)
    end, rend = jpeg_scan_end(coco, sos), jpeg_scan_end(rst, rsos)
    r3 = jpeg_restarts(rst, rsos)[3]
    sof = next(rst[s:e] for m, s, e in jpeg_segments(rst) if m == 0xC0)
    scans = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    ahal = lambda s: s + 5 + 2 * prog[s + 4] + 2      # the scan's Ah/Al byte
    return {
        # tables never defined: libjpeg's standard ones (sequential files)
        "no_dht": _without(coco, lambda m, b: m == 0xC4),
        "no_dht_optimized": _without(opt, lambda m, b: m == 0xC4),
        "no_dht_gray": _without(gray, lambda m, b: m == 0xC4),
        "no_ac_dht_restarts": _without(rst, lambda m, b: m == 0xC4
                                       and b[4] >> 4 == 1),
        "dht_dc0_to_slot_2": _at(coco, dht(coco, 0x00) + 4, b"\x02", 1),
        "dht_ac1_to_slot_3": _at(coco, dht(coco, 0x11) + 4, b"\x13", 1),
        "dht_dc0_to_ac0": _at(coco, dht(coco, 0x00) + 4, b"\x10", 1),
        "sos_names_dc_slot_2": _at(coco, sos + 6, b"\x20", 1),
        "no_dht_progressive": _without(prog, lambda m, b: m == 0xC4),
        "arith_tables_4_and_5": _at(arith, first(arith, 0xDA) + 6, b"\x45",
                                    1),
        # extraneous bytes: skipped with a warning
        "junk_before_dqt": _at(coco, first(coco, 0xDB), b"\x12\x34\x56"),
        "junk_before_dht": _at(coco, first(coco, 0xC4), b"\x00\x07"),
        "junk_before_sos": _at(coco, sos, b"\x12\x34\x56"),
        "ff00_before_dht": _at(coco, first(coco, 0xC4), b"\x05\xff\x00\x07"),
        "junk_before_eoi": _at(coco, len(coco) - 2, b"\x12\x34"),
        "junk_before_rst": _at(rst, r3, b"\x12\x34\x56"),
        "junk_after_rst": _at(rst, r3 + 2, b"\x12\x34\x56"),
        "junk_01ff02_before_sos": _at(coco, sos, b"\x01\xff\x02"),
        # unknown markers
        "marker_9e_in_header": _at(coco, sos, b"\xff\x9e"),
        "marker_f3_in_header": _at(coco, sos, b"\xff\xf3"),
        "marker_9e_at_scan_end": _at(coco, end, b"\xff\x9e"),
        "marker_f3_at_scan_end": _at(coco, end, b"\xff\xf3"),
        "marker_9e_mid_scan": _at(coco, (sos + end) // 2, b"\xff\x9e"),
        "marker_9e_for_rst": _at(rst, r3, b"\xff\x9e", 2),
        "marker_f3_for_rst": _at(rst, r3, b"\xff\xf3", 2),
        "marker_9e_progressive": _at(prog, jpeg_scan_end(prog, psos),
                                     b"\xff\x9e"),
        # a second SOF
        "sof_for_rst": _at(rst, r3, sof, 2),
        "sof_at_scan_end": _at(rst, rend, sof),
        "sof_progressive": _at(prog, jpeg_scan_end(prog, psos), sof),
        # progressions libjpeg warns about (JWRN_BOGUS_PROGRESSION)
        "refinement_ah_skips": _at(prog, ahal(scans[5]), b"\x32", 1),
        "ac_first_scan_as_refinement": _at(prog, ahal(scans[2]), b"\x10",
                                           1),
    }


# The reduced IDCTs on out-of-range coefficients: the 640x480 fixture's
# luma scan decoded with the chroma tables (its SOS byte at sos + 6 set to
# 0x11): bad Huffman codes, huge coefficients.  cv2's decodes at 1/1, 1/2,
# 1/4 and 1/8 are recorded for the card machine, which has no cv2.
IDCT_HASHES = FORMATS / "idct_sha256.json"


def idct_case() -> bytes:
    coco = (TESTDATA / COCO).read_bytes()
    sos = next(s for m, s, _ in jpeg_segments(coco) if m == 0xDA)
    return _at(coco, sos + 6, b"\x11", 1)


def write_header_cases(directory) -> Dict[str, str]:
    """Every case of ``header_cases`` written under ``directory`` as
    ``<case>.jpg``: {case: path}."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    paths = {}
    for case, data in header_cases().items():
        paths[case] = str(d / f"{case}.jpg")
        Path(paths[case]).write_bytes(data)
    return paths
