"""TIFF files through the port's reader (``data/formats.py::read_tiff``
and ``csrc/tiff_decode.cc``) against the JAX package's ``load_image_rgb``
(``cv2.imread``: cv2's bundled libtiff, read through its RGBA interface),
bit for bit, each file under its own name and under a ``.jpg`` name.

- ``cv2.imwrite`` under compressions none, LZW, Deflate (8 and 32946) and
  PackBits, at uint8 and uint16, 1, 3 and 4 channels;
- files from ``tools/format_files.py::tiff_bytes``: II and MM byte order,
  classic TIFF and BigTIFF, strips and tiles (clipped at the right and the
  bottom), chunky and planar, predictor 2 at 8 and 16 bits (which libtiff
  honours for LZW and Deflate only), grey (MINISBLACK, MINISWHITE) at 1, 8
  and 16 bits, RGB at 8 and 16 bits with associated, unassociated,
  unspecified or untagged alpha, grey with extra samples chunky and
  planar, palettes of 1, 4 and 8 bits with 8- and 16-bit colour maps,
  FillOrder 2 uncompressed, Orientation 1..9, several pages;
- the kinds the port still refuses raise naming themselves: CCITT, JPEG,
  CMYK, YCbCr, CIELab, signed, float and 32-bit samples, predictor 3, 2-
  and 4-bit grey (which cv2 refuses too), Orientation 5..8 (which cv2
  fails on), FillOrder 2 with compression.
"""

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import formats, native
from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.tools.format_files import tiff_bytes

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


# the kinds the port refuses: (name in the message, file)
def _refused():
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (H, W, 3))
    bits1 = img[..., :1] % 2
    return {
        "CCITT Group 4": tiff_bytes(bits1, bits=1, photometric=1,
                                    extra_tags={259: (3, [4])}),
        "JPEG compression": tiff_bytes(img, extra_tags={259: (3, [7])}),
        "CMYK": tiff_bytes(np.concatenate([img, img[..., :1]], -1),
                           photometric=5),
        "YCbCr": tiff_bytes(img, photometric=6),
        "CIELab": tiff_bytes(img, photometric=8),
        "sample format 2": tiff_bytes(img, extra_tags={339: (3, [2] * 3)}),
        "sample format 3": tiff_bytes(img, extra_tags={339: (3, [3] * 3)}),
        "32-bit samples": tiff_bytes(img, extra_tags={258: (3, [32] * 3)}),
        "predictor 3": tiff_bytes(img, compression=5, predictor=2,
                                  extra_tags={317: (3, [3])}),
        "2-bit samples": tiff_bytes(img[..., :1] % 4, bits=2, photometric=1),
        "4-bit samples": tiff_bytes(img[..., :1] % 16, bits=4,
                                    photometric=1),
        "Orientation 6": tiff_bytes(img, orientation=6),
        "FillOrder 2": tiff_bytes(img, compression=5,
                                  extra_tags={266: (3, [2])}),
    }


@pytest.mark.parametrize("name", list(_refused()))
def test_refused_kinds_name_themselves(tmp_path, name):
    path = tmp_path / "r.jpg"
    path.write_bytes(_refused()[name])
    with pytest.raises(native.ImageError, match=f"^{path}: TIFF: .*{name}"):
        native.decode_image(str(path))


def test_sniff_names_bigtiff():
    for head in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        assert formats.sniff(head + bytes(12)) == "TIFF"
