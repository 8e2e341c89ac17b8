"""TIFF files through the port's reader (``data/formats.py::read_tiff``
and ``csrc/tiff_decode.cc``; JPEG strips by ``csrc/jpeg_decode.cc``)
against the JAX package's ``load_image_rgb`` (``cv2.imread``: cv2's
bundled libtiff 4.7, read through its RGBA interface), bit for bit, each
file under its own name and under a ``.jpg`` name.

- ``cv2.imwrite`` under compressions none, LZW, Deflate (8 and 32946) and
  PackBits, at uint8 and uint16, 1, 3 and 4 channels;
- files from ``tools/format_files.py::tiff_bytes``: II and MM byte order,
  classic TIFF and BigTIFF, strips and tiles (clipped at the right and the
  bottom), chunky and planar, predictor 2 at 8 and 16 bits (which libtiff
  honours for LZW and Deflate only), grey (MINISBLACK, MINISWHITE) at 1, 8
  and 16 bits, RGB at 8 and 16 bits with associated, unassociated,
  unspecified or untagged alpha, grey with extra samples chunky and
  planar, palettes of 1, 4 and 8 bits with 8- and 16-bit colour maps,
  FillOrder 2 under every compression, old-style (LSB-first) LZW,
  Orientation 1..9, several pages, signed samples (read as unsigned);
- CMYK (4 samples, chunky and planar), YCbCr in packed data units at
  every YCbCrSubsampling libtiff's RGBA reader takes (and 4x4 tiles
  clipped at the right, which its putcontig8bitYCbCr44tile steps over 10
  bytes a unit), under ReferenceBlackWhite and YCbCrCoefficients, and
  CIELab at 8 and 16 bits under a WhitePoint; a ThunderScan palette;
- files libtiff 4.5 writes (a C helper compiled here against the system
  ``tiffio.h``): JPEG compression of YCbCr (libjpeg's RGB through the
  file's sampling), RGB, grey, CMYK and CIELab in strips, tiles and
  planes, and CCITT RLE, Group 3 (1-D and 2-D, with and without fill
  bits) and Group 4 under MINISWHITE and MINISBLACK and FillOrder 1 and
  2, and SGILog; the committed JPEG, fax and SGILog fixtures of
  ``data/testdata/formats`` are this helper's output
  (``test_committed_tiff_fixtures``);
- ``format_files.jpeg_tiff_bytes``: a committed JPEG split into
  JPEGTables and an abbreviated strip decodes to the JPEG's own pixels;
- the kinds cv2 refuses raise naming themselves, each held to cv2's
  refusal: LZMA, Zstandard, WebP and old-JPEG compression (not configured
  in cv2's libtiff), NeXT and 2- and 4-bit grey, float and 32-bit
  samples, predictor 3, mixed SampleFormats, photometric RGB over a JPEG
  sampled 2x2, Orientation 5..8 (which cv2 fails on);
- damaged files: bits flipped, byte counts cut, tails zeroed in strips
  and tiles of every codec (Group 3's only flipped: cut Group 3 strips
  are ROADMAP §C's open fault), byte counts of 0, short and past the
  file's end, a FillOrder 2 tag on data written MSB first;
- SGI LogL and LogLuv under SGILog compression and 24-bit LogLuv under
  SGILog24 (tif_luv.c's 8-bit tone map; the 24-bit decode is held to
  the static libtiff by ``test_torch_port_logluv24.py``).
"""

import subprocess

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import formats, native
from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.tools import format_files
from objectdetectionpl_tpu_torch.tools.fixture_trees import TESTDATA
from objectdetectionpl_tpu_torch.tools.format_files import (
    jpeg_tiff_bytes, set_tiff_counts, thunderscan_bytes, tiff_bytes)

H, W = 21, 37          # tiles of 16 are clipped at the right and the bottom


def like_cv2(tmp_path, data: bytes, name="img"):
    """The port reads ``data`` as cv2 does under a .tiff and a .jpg name;
    returns the image, or None when both refuse it."""
    got_any = None
    for ext in (".tiff", ".jpg"):
        path = tmp_path / f"{name}{ext}"
        path.write_bytes(data)
        try:
            ref = load_image_rgb(str(path))
        except OSError:
            ref = None
        if ref is None:
            for fn in (native.decode_image, common.load_image_rgb):
                with pytest.raises(native.ImageError,
                                   match=f"^{path}: TIFF: "):
                    fn(str(path))
            got_any = None
            continue
        for fn in (native.decode_image, common.load_image_rgb):
            got = fn(str(path))
            assert got.dtype == np.uint8 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref, err_msg=str(path))
        got_any = ref
    return got_any


@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
def test_cv2_imwrite(tmp_path, compression):
    rng = np.random.RandomState(compression)
    for dtype, top in ((np.uint8, 256), (np.uint16, 65536)):
        for channels in (1, 3, 4):
            img = rng.randint(0, top, (23, 31, channels)).astype(dtype)
            path = tmp_path / "w.tiff"
            assert cv2.imwrite(str(path), img[..., 0] if channels == 1
                               else img,
                               [cv2.IMWRITE_TIFF_COMPRESSION, compression])
            assert like_cv2(tmp_path, path.read_bytes()) is not None


LAYOUTS = {"strip": {}, "strips of 3": dict(rows_per_strip=3),
           "tiles": dict(tile=(16, 16)), "planar": dict(planar=2),
           "MM": dict(big_endian=True), "BigTIFF": dict(bigtiff=True),
           "MM BigTIFF planar tiles": dict(planar=2, tile=(16, 32),
                                           big_endian=True, bigtiff=True)}
# (samples a pixel, photometric, ExtraSamples)
SAMPLES = [(3, 2, None), (4, 2, None), (4, 2, [0]), (4, 2, [1]), (4, 2, [2]),
           (1, 1, None), (1, 0, None), (2, 1, [2]), (2, 1, [1]), (2, 0, [2]),
           (3, 1, [2, 0]), (4, 1, None), (4, 1, [0, 0, 0])]


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("predictor", [1, 2])
def test_layouts_and_samples(tmp_path, compression, predictor):
    """Every layout x 8 and 16 bits x the sample kinds of ``SAMPLES``
    (the writer differences the samples whatever the compression; libtiff
    undoes it for LZW and Deflate only, as the reader does)."""
    rng = np.random.RandomState(compression * 2 + predictor)
    for layout in LAYOUTS.values():
        for bits in (8, 16):
            for spp, photometric, extra in SAMPLES:
                img = rng.randint(0, 1 << bits, (H, W, spp))
                kw = dict(layout)
                if spp == 1:
                    kw.pop("planar", None)
                assert like_cv2(tmp_path, tiff_bytes(
                    img, bits=bits, photometric=photometric,
                    compression=compression, predictor=predictor,
                    extra_samples=extra, **kw)) is not None


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_bilevel_and_palettes(tmp_path, compression):
    rng = np.random.RandomState(compression)
    for layout in ({}, dict(rows_per_strip=5), dict(tile=(16, 16)),
                   dict(tile=(32, 48)), dict(big_endian=True)):
        for photometric in (0, 1):
            img = rng.randint(0, 2, (H, W, 1))
            assert like_cv2(tmp_path, tiff_bytes(
                img, bits=1, photometric=photometric,
                compression=compression, **layout)) is not None
        for bits in (1, 4, 8):
            for scale in (1, 257):               # 8- and 16-bit colour maps
                cmap = rng.randint(0, 256, (3, 1 << bits)) * scale
                img = rng.randint(0, 1 << bits, (H, W, 1))
                assert like_cv2(tmp_path, tiff_bytes(
                    img, bits=bits, photometric=3, colormap=cmap,
                    compression=compression, **layout)) is not None


def test_sixteen_bit_rules(tmp_path):
    """cv2's 8-bit output of 16-bit samples: RGB (v + 128) // 257 over all
    65536 values, grey by the high byte."""
    v = np.arange(65536).reshape(256, 256, 1)
    rgb = like_cv2(tmp_path, tiff_bytes(np.repeat(v, 3, -1), bits=16))
    np.testing.assert_array_equal(rgb[..., 0].reshape(-1),
                                  (np.arange(65536) + 128) // 257)
    grey = like_cv2(tmp_path, tiff_bytes(v, bits=16, photometric=1))
    np.testing.assert_array_equal(grey[..., 0].reshape(-1),
                                  np.arange(65536) >> 8)


def test_orientation_fill_order_and_pages(tmp_path):
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (H, W, 3))
    for orientation in (0, 1, 2, 3, 4, 9, 100):
        for layout in ({}, dict(rows_per_strip=4), dict(tile=(16, 16))):
            assert like_cv2(tmp_path, tiff_bytes(
                img, orientation=orientation, **layout)) is not None
    for orientation in (5, 6, 7, 8):
        assert like_cv2(tmp_path, tiff_bytes(
            img, orientation=orientation)) is None
    assert like_cv2(tmp_path, tiff_bytes(      # the writer's bits, reversed
        img, extra_tags={266: (3, [2])})) is not None
    first = like_cv2(tmp_path, tiff_bytes(img, pages=3))
    np.testing.assert_array_equal(first, img)
    np.testing.assert_array_equal(like_cv2(tmp_path, tiff_bytes(
        img, pages=2, bigtiff=True, big_endian=True)), img)


def _jpeg(img, sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420) -> bytes:
    ok, data = cv2.imencode(".jpg", np.asarray(img, np.uint8)[..., ::-1],
                            [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
    assert ok
    return data.tobytes()


# kinds the port once refused: (name in the message, file); the first
# seven read now as cv2 reads them, the others cv2 refuses too
READ_NOW = ("CCITT Group 4", "JPEG compression", "CMYK", "YCbCr", "CIELab",
            "sample format 2", "FillOrder 2")


def _refused():
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (H, W, 3))
    bits1 = img[..., :1] % 2
    return {
        # not T.6 data: cv2 decodes up to the first bad code word, as the
        # port does
        "CCITT Group 4": tiff_bytes(bits1, bits=1, photometric=1,
                                    extra_tags={259: (3, [4])}),
        "JPEG compression": jpeg_tiff_bytes(_jpeg(img)),
        "CMYK": tiff_bytes(np.concatenate([img, img[..., :1]], -1),
                           photometric=5),
        "YCbCr": tiff_bytes(img, photometric=6),
        "CIELab": tiff_bytes(img, photometric=8),
        "sample format 2": tiff_bytes(img, extra_tags={339: (3, [2] * 3)}),
        "FillOrder 2": tiff_bytes(img, compression=5, fill_order=2),
        "sample format 3": tiff_bytes(img, extra_tags={339: (3, [3] * 3)}),
        "32-bit samples": tiff_bytes(img, extra_tags={258: (3, [32] * 3)}),
        "predictor 3": tiff_bytes(img, compression=5, predictor=2,
                                  extra_tags={317: (3, [3])}),
        "2-bit samples": tiff_bytes(img[..., :1] % 4, bits=2, photometric=1),
        "4-bit samples": tiff_bytes(img[..., :1] % 16, bits=4,
                                    photometric=1),
        "Orientation 6": tiff_bytes(img, orientation=6),
        "LZMA": tiff_bytes(img, extra_tags={259: (3, [34925])}),
        "Zstandard": tiff_bytes(img, extra_tags={259: (3, [50000])}),
        "WebP": tiff_bytes(img, extra_tags={259: (3, [50001])}),
        "old JPEG": jpeg_tiff_bytes(_jpeg(img), extra_tags={259: (3, [6])}),
        "NeXT": tiff_bytes(img[..., :1] % 4, bits=2, photometric=1,
                           extra_tags={259: (3, [32766])}),
        "sample formats": tiff_bytes(img, extra_tags={339: (3, [1, 2, 1])}),
        "sampling factors 2,2": jpeg_tiff_bytes(_jpeg(img), photometric=2),
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_refused_kinds_name_themselves(tmp_path, name):
    """Each kind the port refused before, held to cv2: the ones cv2 reads
    read equal to it, the others raise naming themselves, as cv2 fails
    them."""
    data = _refused()[name]
    got = like_cv2(tmp_path, data)
    assert (got is not None) == (name in READ_NOW), name
    if got is None:
        path = tmp_path / "r.jpg"
        path.write_bytes(data)
        with pytest.raises(native.ImageError,
                           match=f"^{path}: TIFF: .*{name}"):
            native.decode_image(str(path))


def test_sniff_names_bigtiff():
    for head in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        assert formats.sniff(head + bytes(12)) == "TIFF"


# ---------------------------------------------------------------------------
# libtiff's own writer: JPEG and CCITT fax, which the port's writers do not
# encode

TIFF_WRITER = r"""
/* tw OUT key=value...: a TIFF written by libtiff from the raw samples on
   stdin (chunky rows, or planes one after another; bit rows for bps 1) */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <tiffio.h>
int main(int argc, char** argv) {
  int w = 0, h = 0, spp = 3, bps = 8, photo = 2, comp = 1, rps = 0, tw = 0,
      th = 0, planar = 1, quality = 75, rgbmode = 0, ysh = 0, ysv = 0,
      fill = 1, t4 = -1, sgilog = -1;
  for (int i = 2; i < argc; ++i) {
    char k[64]; int v;
    if (sscanf(argv[i], "%63[^=]=%d", k, &v) != 2) return 2;
#define S(n) if (!strcmp(k, #n)) n = v;
    S(w) S(h) S(spp) S(bps) S(photo) S(comp) S(rps) S(tw) S(th) S(planar)
    S(quality) S(rgbmode) S(ysh) S(ysv) S(fill) S(t4) S(sgilog)
  }
  size_t cap = 1 << 20, n = 0, got;
  unsigned char* data = malloc(cap);
  while ((got = fread(data + n, 1, cap - n, stdin)) > 0) {
    n += got;
    if (n == cap) data = realloc(data, cap *= 2);
  }
  TIFF* t = TIFFOpen(argv[1], "w");
  TIFFSetField(t, TIFFTAG_IMAGEWIDTH, w);
  TIFFSetField(t, TIFFTAG_IMAGELENGTH, h);
  TIFFSetField(t, TIFFTAG_SAMPLESPERPIXEL, spp);
  TIFFSetField(t, TIFFTAG_BITSPERSAMPLE, bps);
  TIFFSetField(t, TIFFTAG_PHOTOMETRIC, photo);
  TIFFSetField(t, TIFFTAG_COMPRESSION, comp);
  TIFFSetField(t, TIFFTAG_PLANARCONFIG, planar);
  if (fill != 1) TIFFSetField(t, TIFFTAG_FILLORDER, fill);
  if (ysh) TIFFSetField(t, TIFFTAG_YCBCRSUBSAMPLING, ysh, ysv);
  if (comp == 7) {
    TIFFSetField(t, TIFFTAG_JPEGQUALITY, quality);
    if (rgbmode) TIFFSetField(t, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
  }
  if (t4 >= 0) TIFFSetField(t, TIFFTAG_GROUP3OPTIONS, t4);
  if (sgilog >= 0) {
    TIFFSetField(t, TIFFTAG_SGILOGDATAFMT, sgilog);
    if (sgilog == 0) TIFFSetField(t, TIFFTAG_SAMPLEFORMAT, 3);
  }
  int nplanes = planar == 2 ? spp : 1;
  long pixel = (rgbmode ? 3 : planar == 2 ? 1 : spp) * bps / 8;
  long row = bps == 1 ? (w + 7) / 8 : w * pixel;
  long plane = row * h;
  if (tw) {
    TIFFSetField(t, TIFFTAG_TILEWIDTH, tw);
    TIFFSetField(t, TIFFTAG_TILELENGTH, th);
    long trow = tw * pixel;
    unsigned char* buf = calloc(1, trow * th + TIFFTileSize(t));
    for (int p = 0; p < nplanes; ++p)
      for (int y = 0; y < h; y += th)
        for (int x = 0; x < w; x += tw) {
          memset(buf, 0, trow * th);
          for (int r = 0; r < th && y + r < h; ++r)
            memcpy(buf + r * trow,
                   data + p * plane + (y + r) * row + x * pixel,
                   (x + tw <= w ? tw : w - x) * pixel);
          if (TIFFWriteTile(t, buf, x, y, 0, p) < 0) return 3;
        }
  } else {
    if (!rps) rps = h;
    TIFFSetField(t, TIFFTAG_ROWSPERSTRIP, rps);
    for (int p = 0; p < nplanes; ++p)
      for (int y = 0; y < h; y += rps)
        if (TIFFWriteEncodedStrip(t, TIFFComputeStrip(t, y, p),
                                  data + p * plane + y * row,
                                  (y + rps <= h ? rps : h - y) * row) < 0)
          return 4;
  }
  TIFFClose(t);
  return 0;
}
"""


@pytest.fixture(scope="module")
def libtiff(tmp_path_factory):
    """tool(samples, **fields) -> the bytes libtiff writes."""
    d = tmp_path_factory.mktemp("tw")
    (d / "tw.c").write_text(TIFF_WRITER)
    subprocess.run(["cc", "-O1", str(d / "tw.c"), "-ltiff", "-o",
                    str(d / "tw")], check=True, capture_output=True)

    def write(samples, **fields):
        a = np.ascontiguousarray(samples)
        if fields.get("planar") == 2:
            a = np.ascontiguousarray(a.transpose(2, 0, 1))
        out = d / "out.tif"
        subprocess.run([str(d / "tw"), str(out)]
                       + [f"{k}={v}" for k, v in fields.items()],
                       input=a.tobytes(), check=True, capture_output=True)
        return out.read_bytes()
    return write


def _crop():
    """A 61x53 crop of the 500x375 fixture, uint8 RGB."""
    rgb = native.decode_one(str(TESTDATA / format_files.BASE))
    return np.ascontiguousarray(rgb[90:143, 150:211])


JPEG_LAYOUTS = {"strip": {}, "strips of 32": dict(rps=32),
                "tiles": dict(tw=32, th=32)}


@pytest.mark.parametrize("layout", list(JPEG_LAYOUTS))
@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 1), (1, 2),
                                      (4, 2), (4, 1), (2, 4)])
def test_jpeg_ycbcr_as_libjpeg_converts_it(tmp_path, libtiff, layout,
                                           sampling):
    """JPEG compression of photometric YCbCr, which the RGBA reader has
    libjpeg convert to RGB, upsampling each strip or tile alone: the last
    strip shorter, tiles clipped at the right and the bottom."""
    rgb = _crop()
    h, w = rgb.shape[:2]
    assert like_cv2(tmp_path, libtiff(
        rgb, w=w, h=h, comp=7, spp=3, photo=6, rgbmode=1, ysh=sampling[0],
        ysv=sampling[1], **JPEG_LAYOUTS[layout])) is not None


@pytest.mark.parametrize("kind", ["rgb", "rgb planar", "grey", "miniswhite",
                                  "cmyk", "cmyk tiles", "cielab"])
def test_jpeg_samples_as_stored(tmp_path, libtiff, kind):
    """JPEG compression of the other photometrics: the components as
    stored (libjpeg asked for no colour conversion), then the
    photometric's own rule."""
    rgb = _crop()
    h, w = rgb.shape[:2]
    cmyk = np.concatenate([rgb, rgb[..., 1:2] // 2], -1)
    samples, fields = {
        "rgb": (rgb, dict(spp=3, photo=2, rps=16)),
        "rgb planar": (rgb, dict(spp=3, photo=2, planar=2, rps=16)),
        "grey": (rgb[..., 1:2], dict(spp=1, photo=1, rps=32)),
        "miniswhite": (rgb[..., 1:2], dict(spp=1, photo=0)),
        "cmyk": (cmyk, dict(spp=4, photo=5, rps=16)),
        "cmyk tiles": (cmyk, dict(spp=4, photo=5, tw=16, th=16)),
        "cielab": (rgb, dict(spp=3, photo=8, quality=95)),
    }[kind]
    assert like_cv2(tmp_path, libtiff(samples, w=w, h=h, comp=7,
                                      **fields)) is not None


@pytest.mark.parametrize("fixture", ["coco_420_q75_640x480.jpg",
                                     "h2v1_422_q85_256x192.jpg",
                                     "restart7_420_q90_333x251.jpg",
                                     "gray_q85_200x150.jpg",
                                     "odd_420_q75_37x53.jpg"])
def test_jpeg_tables_and_abbreviated_strip(tmp_path, fixture):
    """A committed JPEG split into JPEGTables and an abbreviated strip
    (``format_files.jpeg_tiff_bytes``) reads as the JPEG itself: cv2's
    libtiff has libjpeg decode the two streams as one."""
    jpeg = (TESTDATA / fixture).read_bytes()
    grey = "gray" in fixture
    got = like_cv2(tmp_path, jpeg_tiff_bytes(jpeg,
                                             photometric=1 if grey else 6))
    np.testing.assert_array_equal(got, native.decode_one(
        str(TESTDATA / fixture)))


@pytest.mark.parametrize("layout", ["one strip", "strips of 16",
                                    "tiles"])
def test_jpeg_strip_shorter_than_its_segments(tmp_path, libtiff, layout):
    """A JPEG strip or tile whose byte count ends inside its stream, at
    every byte of the second one: cv2 refuses the file where the count
    ends inside the stream's marker segments (before its scan data), and
    reads on where it ends inside the scan data, libjpeg given a fake EOI
    (premature end of data); the port does the same."""
    rgb = _crop()
    h, w = rgb.shape[:2]
    data = libtiff(rgb, w=w, h=h, comp=7, spp=3, photo=6, rgbmode=1, ysh=2,
                   ysv=2, **{"one strip": {}, "strips of 16": dict(rps=16),
                             "tiles": dict(tw=32, th=32)}[layout])
    tags, _ = formats._tiff_ifd(data)
    counts = tags.get(279) or tags.get(325)
    k = min(1, len(counts) - 1)
    reads = [like_cv2(tmp_path, set_tiff_counts(data, [
        end if i == k else None for i in range(len(counts))])) is not None
        for end in range(1, counts[k])]
    # refused while the header lasts, then read on
    assert not reads[0] and reads[-1]
    assert reads == sorted(reads)


FAX = {"RLE": dict(comp=2), "G3 1-D": dict(comp=3, t4=0),
       "G3 2-D": dict(comp=3, t4=1), "G3 1-D fill bits": dict(comp=3, t4=4),
       "G3 2-D fill bits": dict(comp=3, t4=5), "G4": dict(comp=4)}


@pytest.mark.parametrize("fill", [1, 2])
@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("codec", list(FAX))
def test_ccitt_fax(tmp_path, libtiff, codec, photometric, fill):
    """CCITT RLE, Group 3 and Group 4 as tif_fax3.c decodes them, in one
    strip, strips of 8 and 20 rows and 64x16 tiles, on a dithered image
    (short runs of every length) with a white row, a half-black row and a
    random row."""
    rng = np.random.RandomState(photometric * 2 + fill)
    grey = _crop()[..., 1]
    h, w = grey.shape
    bayer = np.array([[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9],
                      [15, 7, 13, 5]]) * 16 + 8
    bits = grey > np.tile(bayer, (h // 4 + 1, w // 4 + 1))[:h, :w]
    bits[h // 3], bits[h // 2, :w // 2], bits[-1] = 0, 1, rng.rand(w) < 0.5
    packed = np.packbits(bits, axis=1)
    for layout in ({}, dict(rps=8), dict(rps=20), dict(tw=64, th=16)):
        assert like_cv2(tmp_path, libtiff(
            packed, w=w, h=h, spp=1, bps=1, photo=photometric, fill=fill,
            **FAX[codec], **layout)) is not None


COMMITTED_TIFF = {
    "tiff_jpeg_strips": dict(comp=7, spp=3, photo=6, rgbmode=1, ysh=2, ysv=2,
                             rps=32),
    "tiff_jpeg_tiles": dict(comp=7, spp=3, photo=6, rgbmode=1, ysh=2, ysv=1,
                            tw=64, th=64),
    "tiff_g3_2d": dict(spp=1, bps=1, photo=0, comp=3, t4=5, rps=40),
    "tiff_g4": dict(spp=1, bps=1, photo=0, comp=4),
    "tiff_ccitt_rle": dict(spp=1, bps=1, photo=1, comp=2, fill=2, rps=16),
    "tiff_logluv": dict(spp=3, bps=32, photo=32845, comp=34676, sgilog=0,
                        rps=16),
    "tiff_logl": dict(spp=1, bps=32, photo=32844, comp=34676, sgilog=0),
    "tiff_logluv24": dict(spp=3, bps=32, photo=32845, comp=34677, sgilog=0,
                          rps=16),
    "tiff_logluv24_tiles": dict(spp=3, bps=32, photo=32845, comp=34677,
                                sgilog=0, tw=16, th=16),
}


def test_committed_tiff_fixtures(libtiff):
    """The committed TIFFs of ``data/testdata/formats`` are libtiff's
    writes of the 160x120 crop ``rgb[100:220, 150:310]`` of the 500x375
    fixture: JPEG at quality 75; the fax files of its green channel
    against a 4x4 Bayer matrix of thresholds 16k + 8; the SGILog files,
    54x40, of its every third pixel as XYZ (sRGB's matrix on (v / 255) **
    2.2, float32; LogL its Y)."""
    rgb = native.decode_one(str(TESTDATA / format_files.BASE))
    crop = np.ascontiguousarray(rgb[100:220, 150:310])
    bayer = np.array([[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9],
                      [15, 7, 13, 5]]) * 16 + 8
    bits = np.packbits(crop[..., 1] > np.tile(bayer, (30, 40)), axis=1)
    r, g, b = np.moveaxis((crop[::3, ::3] / 255) ** 2.2, -1, 0)
    xyz = np.stack([0.4124 * r + 0.3576 * g + 0.1805 * b,
                    0.2126 * r + 0.7152 * g + 0.0722 * b,
                    0.0193 * r + 0.1192 * g + 0.9505 * b],
                   -1).astype(np.float32)
    for kind, fields in COMMITTED_TIFF.items():
        samples, size = ((bits, (160, 120)) if fields.get("bps") == 1 else
                         (xyz[..., 1:2] if fields["spp"] == 1 else xyz,
                          (54, 40)) if "sgilog" in fields else
                         (crop, (160, 120)))
        assert libtiff(samples, w=size[0], h=size[1], **fields) == \
            format_files.COMMITTED[kind].read_bytes(), kind


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_cmyk_ycbcr_cielab(tmp_path, compression):
    """CMYK (chunky and planar, 4 samples), YCbCr in data units at every
    subsampling the RGBA reader takes (44, 42, 41, 22, 21, 12, 11; 24 and
    14 refused as cv2 refuses them) and planar 1x1, CIELab at 8 and 16
    bits, in every layout."""
    rng = np.random.RandomState(compression)
    img3 = rng.randint(0, 256, (H, W, 3))
    img4 = rng.randint(0, 256, (H, W, 4))
    lab16 = rng.randint(0, 65536, (H, W, 3))
    for layout in LAYOUTS.values():
        kw = dict(layout, compression=compression)
        assert like_cv2(tmp_path, tiff_bytes(img4, photometric=5,
                                             **kw)) is not None
        assert like_cv2(tmp_path, tiff_bytes(img3, photometric=6,
                                             ycbcr_subsampling=(1, 1),
                                             **kw)) is not None
        chunky = "planar" not in layout
        for bits, img in ((8, img3), (16, lab16)):
            assert (like_cv2(tmp_path, tiff_bytes(
                img, bits=bits, photometric=8, **kw)) is not None) == chunky
        if not chunky:
            continue
        for sub in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (2, 4),
                    (1, 4)):
            got = like_cv2(tmp_path, tiff_bytes(
                img3, photometric=6, ycbcr_subsampling=sub, **kw))
            assert (got is not None) == (sub not in ((2, 4), (1, 4))), sub


def test_ycbcr_and_cielab_tags(tmp_path):
    """TIFFYCbCrToRGBInit's float arithmetic under other
    ReferenceBlackWhite and YCbCrCoefficients values, the default 2x2
    subsampling without the tag; CIELab under a D65 WhitePoint, and 2^16
    random L, a, b triples with every L and the a and b extremes."""
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (64, 64, 3))
    for tags in ({}, {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240,
                               1])},
                 {532: (5, [1, 3, 700, 3, 50, 1, 200, 1, 300, 7, 10, 1])},
                 {529: (5, [2126, 10000, 7152, 10000, 722, 10000])}):
        assert like_cv2(tmp_path, tiff_bytes(
            img, photometric=6, ycbcr_subsampling=(1, 1),
            extra_tags=tags)) is not None
    assert like_cv2(tmp_path, tiff_bytes(img, photometric=6)) is not None
    lab = rng.randint(0, 256, (256, 256, 3))
    lab[0, :, 0] = np.arange(256)
    lab[1, :256:4, 1:] = [[0, 0], [127, 128], [128, 127], [255, 255]] * 16
    for tags in ({}, {318: (5, [3127, 10000, 3290, 10000])}):
        assert like_cv2(tmp_path, tiff_bytes(lab, photometric=8,
                                             extra_tags=tags)) is not None


def test_ycbcr_44_tiles_clipped(tmp_path):
    """4x4 units in tiles clipped at the right: libtiff's 44 routine skips
    a clipped tile's hidden units at 10 bytes each, so the rows after a
    tile's first unit row shift; the 42 and 22 routines skip whole units."""
    rng = np.random.RandomState(7)
    for w in (37, 45, 50, 63):
        img = rng.randint(0, 256, (40, w, 3))
        for sub in ((4, 4), (4, 2), (2, 2)):
            assert like_cv2(tmp_path, tiff_bytes(
                img, photometric=6, ycbcr_subsampling=sub,
                tile=(32, 16))) is not None


@pytest.mark.parametrize("bits", [8, 16])
def test_old_lzw_and_fill_order(tmp_path, bits):
    """Old-style LZW (LSB first, widened late) with and without predictor
    2, and FillOrder 2 under every codec; uncompressed FillOrder 2 tiles
    of other than a multiple of 1024 bytes, which cv2's libtiff refuses."""
    rng = np.random.RandomState(bits)
    img = rng.randint(0, 4, (H, W, 3)) * (1 << (bits - 2))
    big = np.repeat(rng.randint(0, 1 << bits, (60, 1, 3)), 300, 1)
    for layout in LAYOUTS.values():
        for predictor in (1, 2):
            assert like_cv2(tmp_path, tiff_bytes(
                img, bits=bits, compression=5, old_lzw=True,
                predictor=predictor, **layout)) is not None
        for compression in (1, 5, 8, 32773):
            like_cv2(tmp_path, tiff_bytes(img, bits=bits,
                                          compression=compression,
                                          fill_order=2, **layout))
    assert like_cv2(tmp_path, tiff_bytes(big, bits=bits, compression=5,
                                         old_lzw=True)) is not None
    assert like_cv2(tmp_path, tiff_bytes(img[:32, :32], bits=bits,
                                         fill_order=2, tile=(32, 32),
                                         planar=2)) is not None


def test_thunderscan_palette(tmp_path):
    """ThunderScan's runs, 2- and 3-bit deltas and raw pixels under a 4-bit
    palette (cv2 refuses 4-bit grey); runs that end a row."""
    rng = np.random.RandomState(8)
    cmap = rng.randint(0, 256, (3, 16)) * 257
    for t in range(12):
        w = rng.randint(1, 40)
        pix = np.where(rng.rand(5, w) < 0.6, 7, rng.randint(0, 16, (5, w)))
        if t % 2:
            pix = np.cumsum(rng.randint(-1, 2, (5, w)), 1) % 16
        assert like_cv2(tmp_path, tiff_bytes(
            pix[..., None], bits=4, photometric=3, colormap=cmap,
            chunks=[thunderscan_bytes(pix)],
            extra_tags={259: (3, [32809])})) is not None
    grey = tiff_bytes(pix[..., None], bits=4, photometric=1,
                      chunks=[thunderscan_bytes(pix)],
                      extra_tags={259: (3, [32809])})
    assert like_cv2(tmp_path, grey) is None


def test_signed_samples_read_unsigned(tmp_path):
    """SampleFormat 2 (signed): cv2's RGBA read takes the bits as
    unsigned, at 1, 8 and 16 bits, grey, RGB, palette, CMYK, YCbCr."""
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (H, W, 4))
    for samples, kw in ((img[..., :3], {}), (img[..., :1], dict(
            photometric=1)), (img[..., :1] % 2, dict(bits=1, photometric=1)),
            (img, dict(photometric=5)), (img[..., :3], dict(
                photometric=6, ycbcr_subsampling=(2, 2))),
            (img[..., :1], dict(photometric=3, colormap=rng.randint(
                0, 256, (3, 256)))),
            (img[..., :3] * 257, dict(bits=16))):
        spp = samples.shape[2]
        assert like_cv2(tmp_path, tiff_bytes(
            samples, extra_tags={339: (3, [2] * spp)}, **kw)) is not None


@pytest.mark.parametrize("kind", ["LogL", "LogL float", "LogLuv",
                                  "LogLuv 24-bit"])
def test_sgilog(tmp_path, libtiff, kind):
    """SGI LogL and LogLuv under SGILog compression, and 24-bit LogLuv
    under SGILog24, which the RGBA reader has tif_luv.c tone-map to 8 bits
    (256 sqrt(Y); LogLuv through XYZ and CCIR-709 primaries), in strips
    and tiles."""
    rng = np.random.RandomState(10)
    h, w = 40, 53
    samples, fields = {
        "LogL": (rng.randint(0, 32768, (h, w, 1)).astype(np.int16),
                 dict(spp=1, bps=16, photo=32844, comp=34676, sgilog=1)),
        "LogL float": ((rng.rand(h, w, 1) * 1.5).astype(np.float32),
                       dict(spp=1, bps=32, photo=32844, comp=34676,
                            sgilog=0)),
        "LogLuv": ((rng.rand(h, w, 3) * 1.2).astype(np.float32),
                   dict(spp=3, bps=32, photo=32845, comp=34676, sgilog=0)),
        "LogLuv 24-bit": ((rng.rand(h, w, 3) * 1.2).astype(np.float32),
                          dict(spp=3, bps=32, photo=32845, comp=34677,
                               sgilog=0)),
    }[kind]
    for layout in (dict(rps=7), dict(tw=16, th=16)):
        assert like_cv2(tmp_path, libtiff(samples, w=w, h=h, **fields,
                                          **layout)) is not None


def _damaged(data: bytes, rng, how: str) -> bytes:
    """One strip or tile of ``data`` with bits flipped, its byte count cut,
    or its bytes zeroed from a point to its end."""
    tags, _ = formats._tiff_ifd(data)
    offs = tags.get(273) or tags.get(324)
    counts = tags.get(279) or tags.get(325)
    i = rng.randint(len(offs))
    out = bytearray(data)
    if how == "flip":
        for _ in range(rng.randint(1, 4)):
            out[offs[i] + rng.randint(counts[i])] ^= 1 << rng.randint(8)
    elif how == "zero":
        start = offs[i] + rng.randint(counts[i])
        out[start:offs[i] + counts[i]] = bytes(offs[i] + counts[i] - start)
    else:
        return set_tiff_counts(data, [rng.randint(1, max(counts[i], 2))
                                  if k == i else None
                                  for k in range(len(offs))])
    return bytes(out)


DAMAGED = ["LZW", "LZW predictor 16-bit MM", "old LZW", "Deflate",
           "Deflate tiles predictor", "PackBits planar", "uncompressed strips",
           "uncompressed tiles", "G4", "RLE", "G3 2-D", "ThunderScan", "JPEG",
           "SGILog LogLuv", "G3 1-D", "G3 2-D fill bits tiles",
           "SGILog24 tiles"]


@pytest.mark.parametrize("kind", DAMAGED)
def test_damaged_strips_read_on(tmp_path, libtiff, kind):
    """cv2 calls TIFFReadRGBAStrip / Tile once a strip or tile, and libtiff
    reads on past a codec that fails one (its buffer is allocated): what
    the codec wrote stays, zeros after, without the predictor and the byte
    swap.  A byte count of 0 or past the file's end fails the image, and
    an uncompressed file's counts are re-estimated where TIFFReadDirectory
    finds them wrong.  Bits flipped, counts cut and tails zeroed, 6 seeds
    each."""
    rng = np.random.RandomState(DAMAGED.index(kind))
    img = np.repeat(rng.randint(0, 256, (12, W, 3)), 2, 0)
    bits = np.packbits(np.arange(61)[None] // rng.randint(1, 9, (24, 1)) % 2,
                       axis=1)
    pix = np.cumsum(rng.randint(-1, 2, (24, 40)), 1) % 16
    make = {
        "LZW": lambda: tiff_bytes(img, compression=5, rows_per_strip=8),
        "LZW predictor 16-bit MM": lambda: tiff_bytes(
            img * 257, bits=16, compression=5, predictor=2, big_endian=True,
            rows_per_strip=8),
        "old LZW": lambda: tiff_bytes(img, compression=5, old_lzw=True,
                                      rows_per_strip=8),
        "Deflate": lambda: tiff_bytes(img, compression=8, rows_per_strip=8),
        "Deflate tiles predictor": lambda: tiff_bytes(
            img, compression=8, predictor=2, tile=(16, 16)),
        "PackBits planar": lambda: tiff_bytes(img, compression=32773,
                                              planar=2, rows_per_strip=5),
        "uncompressed strips": lambda: tiff_bytes(img, rows_per_strip=8),
        "uncompressed tiles": lambda: tiff_bytes(img, tile=(16, 16)),
        "G4": lambda: libtiff(bits, w=61, h=24, spp=1, bps=1, photo=0,
                              comp=4, rps=8),
        "RLE": lambda: libtiff(bits, w=61, h=24, spp=1, bps=1, photo=0,
                               comp=2, rps=8),
        "G3 2-D": lambda: libtiff(bits, w=61, h=24, spp=1, bps=1, photo=0,
                                  comp=3, t4=1, rps=8),
        "ThunderScan": lambda: tiff_bytes(
            pix[..., None], bits=4, photometric=3,
            colormap=rng.randint(0, 256, (3, 16)) * 257,
            chunks=[thunderscan_bytes(pix)], extra_tags={259: (3, [32809])}),
        "JPEG": lambda: libtiff(np.repeat(img, 2, 1)[:, :61].astype(np.uint8),
                                w=61, h=24, comp=7, spp=3, photo=6,
                                rgbmode=1, ysh=2, ysv=2, rps=16),
        "SGILog LogLuv": lambda: libtiff(
            (img / 200).astype(np.float32), w=W, h=24, spp=3, bps=32,
            photo=32845, comp=34676, sgilog=0, rps=8),
        "G3 1-D": lambda: libtiff(bits, w=61, h=24, spp=1, bps=1, photo=0,
                                  comp=3, t4=0, rps=8),
        "G3 2-D fill bits tiles": lambda: libtiff(
            bits, w=61, h=24, spp=1, bps=1, photo=1, comp=3, t4=5, tw=32,
            th=16),
        "SGILog24 tiles": lambda: libtiff(
            (img / 200).astype(np.float32), w=W, h=24, spp=3, bps=32,
            photo=32845, comp=34677, sgilog=0, tw=16, th=16),
    }[kind]
    data = make()
    for how in ("flip", "cut", "zero"):
        for _ in range(6):
            like_cv2(tmp_path, _damaged(data, rng, how))


G3 = {"1-D": (0, 0), "2-D": (1, 22), "1-D fill bits": (4, 4),
      "2-D fill bits": (5, 1)}          # name: (T4Options, seed)


@pytest.mark.parametrize("options", list(G3))
def test_group3_strips_that_end_early(tmp_path, libtiff, options):
    """Group 3 strips of 8 rows whose byte count is cut, or whose tail is
    zeroed, at every byte: inside runs, at rows' EOLs and inside 2-D
    rows.  libtiff 4.7 (cv2's), where the data end before an EOL, decodes
    the strip again from its first byte without EOLs, and that mode stays
    for the image's later strips, whose 2-D codes can read past the
    reference row into what earlier strips left in the codec's run
    arrays.  A random 200-pixel-wide image; the cut strip is the second
    of three."""
    t4, seed = G3[options]
    rng = np.random.RandomState(seed)
    bits = np.packbits(rng.rand(24, 200) < rng.uniform(.05, .5), axis=1)
    data = libtiff(bits, w=200, h=24, spp=1, bps=1, photo=0, comp=3, t4=t4,
                   rps=8)
    tags, _ = formats._tiff_ifd(data)
    at, n = tags[273][1], tags[279][1]
    path = tmp_path / "g3.tif"
    for end in range(n):
        cut = bytearray(data)
        cut[at + end:at + n] = bytes(n - end)
        for damaged in (bytes(cut), set_tiff_counts(data, [None, end or 1])):
            path.write_bytes(damaged)
            np.testing.assert_array_equal(native.decode_image(str(path)),
                                          load_image_rgb(str(path)),
                                          err_msg=f"{end}")


def test_strip_and_tile_counts(tmp_path):
    """Byte counts of 0, 1, one short and past the file's end on each strip
    or tile of uncompressed and LZW files: EstimateStripByteCounts where
    libtiff finds the counts wrong, a failed image or a zeroed strip
    where it does not, a tile whose count is not the tile's refused."""
    rng = np.random.RandomState(12)
    img = rng.randint(0, 256, (24, W, 3))
    for data in (tiff_bytes(img, rows_per_strip=8), tiff_bytes(img),
                 tiff_bytes(img, tile=(16, 16)),
                 tiff_bytes(img, compression=5, rows_per_strip=8)):
        tags, _ = formats._tiff_ifd(data)
        counts = tags.get(279) or tags.get(325)
        for i in range(len(counts)):
            for c in (0, 1, counts[i] - 1, counts[i] + 10,
                      counts[i] + 100000):
                like_cv2(tmp_path, set_tiff_counts(
                    data, [c if k == i else None
                           for k in range(len(counts))]))


def test_fill_order_tag_on_msb_first_data(tmp_path):
    """A FillOrder 2 tag on data written MSB first: libtiff reverses the
    bits and its codecs decode what they can of the result."""
    for seed in range(4):
        img = np.random.RandomState(seed).randint(0, 256, (30, 41, 3))
        for compression in (5, 8, 32773):
            like_cv2(tmp_path, tiff_bytes(img, compression=compression,
                                          rows_per_strip=7,
                                          extra_tags={266: (3, [2])}))
