"""24-bit SGI LogLuv (SGILog24) through the port's TIFF reader
(``data/formats.py``: ``_uv_cells``, ``_logluv24_xyz``, ``_xyz_rgb``)
against libtiff's own tif_luv.c, bit for bit: a harness compiled here and
linked against the system's static ``libtiff.a`` calls ``uv_decode``,
``LogL10toY``, ``LogLuv24toXYZ`` and ``XYZtoRGB24``, which the shared
library hides.

- every one of the 16,384 14-bit uv indices: ``uv_decode``'s (u', v')
  where it defines one (16,289 cells), and ``LogLuv24toXYZ``'s neutral
  point past them, at several luminances;
- every one of the 1,024 10-bit luminances at several uv indices;
- a seeded million 24-bit codes;
- files of those codes through ``native.decode_image`` against
  ``load_image_rgb`` (cv2's libtiff 4.7), the indices past the last cell
  among them.
"""

import subprocess

import numpy as np
import pytest

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import formats, native
from objectdetectionpl_tpu_torch.tools.format_files import tiff_bytes

HARNESS = r"""
/* h uv: for each 14-bit index uv_decode's return, u', v'; then LogL10toY
   of each 10-bit Le.  h codes: for each uint32 code on stdin
   LogLuv24toXYZ's three floats and XYZtoRGB24's three bytes. */
#include <stdint.h>
#include <stdio.h>
#include <string.h>
int uv_decode(double*, double*, int);
double LogL10toY(int);
void LogLuv24toXYZ(uint32_t, float*);
void XYZtoRGB24(float*, uint8_t*);
int main(int argc, char** argv) {
  if (argc > 1 && !strcmp(argv[1], "uv")) {
    for (int c = 0; c < 16384; ++c) {
      double u = 0, v = 0;
      int r = uv_decode(&u, &v, c);
      fwrite(&r, 4, 1, stdout);
      fwrite(&u, 8, 1, stdout);
      fwrite(&v, 8, 1, stdout);
    }
    for (int le = 0; le < 1024; ++le) {
      double y = LogL10toY(le);
      fwrite(&y, 8, 1, stdout);
    }
    return 0;
  }
  uint32_t p;
  while (fread(&p, 4, 1, stdin) == 1) {
    float xyz[3];
    uint8_t rgb[3];
    LogLuv24toXYZ(p, xyz);
    XYZtoRGB24(xyz, rgb);
    fwrite(xyz, 4, 3, stdout);
    fwrite(rgb, 1, 3, stdout);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def tif_luv(tmp_path_factory):
    """run(mode, stdin bytes) -> the harness's stdout."""
    d = tmp_path_factory.mktemp("luv")
    (d / "h.c").write_text(HARNESS)
    subprocess.run(["gcc", "-O1", str(d / "h.c"), "-l:libtiff.a", "-lm",
                    "-ljpeg", "-lz", "-ldeflate", "-llzma", "-lzstd", "-ljbig",
                    "-lwebp", "-lLerc", "-o", str(d / "h")], check=True,
                   capture_output=True)

    def run(*args, stdin=b""):
        return subprocess.run([str(d / "h"), *args], input=stdin,
                              check=True, capture_output=True).stdout
    return run


def _held(tif_luv, codes: np.ndarray):
    """The port's XYZ and RGB of ``codes`` equal libtiff's bit for bit."""
    codes = np.asarray(codes, np.uint32)
    out = np.frombuffer(tif_luv("codes", stdin=codes.tobytes()),
                        np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]))
    xyz = formats._logluv24_xyz(codes)
    np.testing.assert_array_equal(xyz.view(np.uint32),
                                  out["xyz"].view(np.uint32))
    np.testing.assert_array_equal(formats._xyz_rgb(xyz), out["rgb"])


def test_uv_cells_and_luminances_equal_libtiff(tif_luv):
    """The committed uvcode.h table read back: ``uv_decode``'s (u', v') of
    every index it defines, the neutral point of the 95 it does not, and
    LogL10toY of every Le, as doubles bit for bit."""
    out = tif_luv("uv")
    uv = np.frombuffer(out[:16384 * 20], np.dtype(
        [("r", "<i4"), ("u", "<f8"), ("v", "<f8")]))
    defined = uv["r"] == 0
    assert defined.sum() == 16289 and not defined[16289:].any()
    u, v = formats._uv_cells()
    np.testing.assert_array_equal(u[defined].view(np.uint64),
                                  uv["u"][defined].view(np.uint64))
    np.testing.assert_array_equal(v[defined].view(np.uint64),
                                  uv["v"][defined].view(np.uint64))
    assert (u[~defined] == 0.210526316).all()
    assert (v[~defined] == 0.473684211).all()
    y = np.frombuffer(out[16384 * 20:], "<f8")
    formats._logluv24_xyz(np.zeros(1, np.uint32))      # builds the table
    np.testing.assert_array_equal(formats._LOGL10_Y.view(np.uint64),
                                  y.view(np.uint64))


@pytest.mark.parametrize("le", [1, 64, 511, 640, 704, 768, 800, 832, 1023])
def test_every_uv_index(tif_luv, le):
    """All 16,384 uv indices, the 95 past the last cell among them, at one
    luminance: black, dim, around Y = 1 where the tone map saturates, and
    the brightest."""
    _held(tif_luv, (le << 14) | np.arange(16384))


@pytest.mark.parametrize("ce", [0, 3, 8144, 16268, 16288, 16289, 16383])
def test_every_luminance(tif_luv, ce):
    """All 1,024 luminances, Le 0 (black) among them, at one uv index:
    the first and a late cell of the first row, a middle one, the last
    row's first and last cells, and two indices past them."""
    _held(tif_luv, (np.arange(1024) << 14) | ce)


def test_a_million_codes(tif_luv):
    """A seeded million 24-bit codes, XYZ and RGB."""
    _held(tif_luv, np.random.RandomState(24).randint(0, 1 << 24, 10 ** 6))


def _file(codes: np.ndarray, w: int, **kw) -> bytes:
    """An SGILog24 TIFF whose strips or tiles hold ``codes`` as stored."""
    b = np.stack([codes >> 16, codes >> 8, codes], -1).astype(np.uint8)
    return tiff_bytes(np.zeros((len(codes) // w, w, 3)), chunks=[b.tobytes()],
                      extra_tags={259: (3, [34677]), 262: (3, [32845]),
                                  258: (3, [16, 16, 16])}, **kw)


@pytest.mark.parametrize("le", [300, 800])
def test_indices_as_cv2_reads_them(tmp_path, le):
    """Every uv index in a 128x128 file at one luminance, through
    ``native.decode_image`` and cv2: cv2's libtiff 4.7 maps the indices
    past the last cell to the neutral point as 4.5 does."""
    path = tmp_path / "luv.tif"
    path.write_bytes(_file((le << 14) | np.arange(16384), 128))
    ref = load_image_rgb(str(path))
    np.testing.assert_array_equal(native.decode_image(str(path)), ref)
    assert (ref.reshape(-1, 3)[16289:] == ref.reshape(-1, 3)[16289]).all()
