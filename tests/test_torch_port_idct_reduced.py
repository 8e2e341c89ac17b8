"""The reduced IDCTs (``csrc/jpeg_decode.cc::idct_4x4``, ``idct_2x2``,
``idct_1x1``) on out-of-range coefficients, as libjpeg-turbo's
``jsimd_idct_4x4_sse2`` and ``jsimd_idct_2x2_sse2`` (jidctred-sse2.asm)
and jidctred.c's ``jpeg_idct_1x1`` compute them.

The lanes wrap every 32-bit sum, the descale's rounding add included,
before its arithmetic shift; the 2x2 IDCT keeps its column 0 in 32 bits
between the passes and takes no shortcut.

- ``format_files.idct_case``: the 640x480 fixture's luma scan decoded with
  the chroma tables, at 1/1, 1/2, 1/4 and 1/8 on the imread route against
  ``cv2.imread`` / ``IMREAD_REDUCED_COLOR_{2,4,8}`` and cv2's recorded
  hashes (``data/testdata/formats/idct_sha256.json``, which
  ``chip_smoke.py``'s jpeg_headers checks on the card's host); on the
  fused route against the JAX library's ``decode_preproc_batch`` at the
  denominators 1, 2, 4 and 8;
- the same for the other table swaps of the two fixtures of one scan;
- a 16-bit DQT whose DC entry is above 32767 (a negative multiplier in
  libjpeg-turbo's 16-bit lanes) at every scale;
- 200,000 random blocks a mode through the port's IDCTs and the system
  libjpeg-turbo's SSE2 functions (a harness compiled here that includes
  ``csrc/jpeg_decode.cc`` and links ``libjpeg.a``): equal output.
"""

import hashlib
import json
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.tools import format_files
from objectdetectionpl_tpu_torch.tools.fixture_trees import TESTDATA
from test_torch_port_data import jax_library  # noqa: F401
from test_torch_port_jpeg_damaged import _fused_route

FLAGS = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
         4: cv2.IMREAD_REDUCED_COLOR_4, 8: cv2.IMREAD_REDUCED_COLOR_8}


def _cv2(path: str, denom: int) -> np.ndarray:
    return cv2.imread(path, FLAGS[denom])[..., ::-1]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("idct") / "luma_chroma_tables.jpg"
    path.write_bytes(format_files.idct_case())
    return str(path)


@pytest.mark.parametrize("denom", [1, 2, 4, 8])
def test_case_on_the_imread_route(case, denom):
    want = _cv2(case, denom)
    got = native.decode_one(case, denom, imread=True)
    np.testing.assert_array_equal(got, want)
    record = json.loads(format_files.IDCT_HASHES.read_text())[str(denom)]
    assert list(got.shape) == record["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == record["sha256"]
    if denom == 1:
        np.testing.assert_array_equal(native.decode_image(case),
                                      load_image_rgb(case))


def test_case_on_the_fused_route(case, jax_library):
    assert _fused_route(case, (640, 480))


def _swapped(fixture: str, at: int, value: int) -> bytes:
    data = (TESTDATA / fixture).read_bytes()
    sos = next(s for m, s, _ in format_files.jpeg_segments(data)
               if m == 0xDA)
    return data[:sos + at] + bytes([value]) + data[sos + at + 1:]


@pytest.mark.parametrize("fixture", ["coco_420_q75_640x480.jpg",
                                     "voc_420_q75_500x375.jpg"])
def test_table_swaps(tmp_path, jax_library, fixture):
    """Each component's scan read with the other component's tables, at
    every scale on both routes."""
    w, h = (640, 480) if "640" in fixture else (500, 375)
    for at, value in ((6, 0x11), (8, 0x00), (10, 0x00), (6, 0x01),
                      (8, 0x10)):
        path = str(tmp_path / f"swap_{at}_{value}.jpg")
        Path(path).write_bytes(_swapped(fixture, at, value))
        for denom in FLAGS:
            np.testing.assert_array_equal(
                native.decode_one(path, denom, imread=True),
                _cv2(path, denom), err_msg=f"{path} 1/{denom}")
        _fused_route(path, (w, h))


def test_dc_quantization_past_32767(tmp_path):
    """A 16-bit DQT whose DC value is above 32767, which the SIMD IDCTs
    multiply as a negative 16-bit value, at every scale."""
    data = (TESTDATA / "gray_q85_200x150.jpg").read_bytes()
    dqt = next(s for m, s, _ in format_files.jpeg_segments(data)
               if m == 0xDB)
    n = int.from_bytes(data[dqt + 2:dqt + 4], "big")
    table = data[dqt + 5:dqt + 5 + 64]
    body = bytes([0x10]) + b"".join(
        (40000 if i == 0 else v).to_bytes(2, "big")
        for i, v in enumerate(table))
    patched = (data[:dqt] + b"\xff\xdb" + (len(body) + 2).to_bytes(2, "big")
               + body + data[dqt + 2 + n:])
    path = str(tmp_path / "dqt16.jpg")
    Path(path).write_bytes(patched)
    for denom in FLAGS:
        np.testing.assert_array_equal(
            native.decode_one(path, denom, imread=True), _cv2(path, denom),
            err_msg=f"1/{denom}")


HARNESS = r"""
#include "jpeg_decode.cc"
#include <random>
extern "C" {
void jsimd_idct_4x4_sse2(void*, int16_t*, unsigned char**, unsigned);
void jsimd_idct_2x2_sse2(void*, int16_t*, unsigned char**, unsigned);
}
int main(int argc, char** argv) {
  std::mt19937 rng(atoi(argv[1]));
  alignas(16) int16_t coef[64];
  alignas(16) int16_t qt[64];
  uint16_t q[64];
  unsigned char ref[8][8], got[8][8];
  unsigned char* rows[8];
  for (int r = 0; r < 8; ++r) rows[r] = ref[r];
  long bad = 0, n = atol(argv[2]);
  auto any = [&] { return static_cast<int>(rng() % 65536) - 32768; };
  for (long t = 0; t < n; ++t) {
    const int mode = t % 6;
    for (int i = 0; i < 64; ++i) {
      qt[i] = q[i] = 1 + rng() % 255;
      const bool row0 = i < 8, row4 = i >= 32 && i < 40;
      switch (mode) {
        case 0: coef[i] = any(); break;
        case 1: coef[i] = static_cast<int>(rng() % 2048) - 1024; break;
        case 2: coef[i] = rng() % 4 ? 0 : any(); break;
        case 3: coef[i] = rng() % 8 ? 0 : static_cast<int>(rng() % 16) - 8;
                break;
        case 4: coef[i] = row0 || row4 ? any() : 0; break;
        default: coef[i] = i == 0 || (row0 && rng() % 2) ? any() : 0;
      }
    }
    for (int size : {4, 2}) {
      std::memset(ref, 0, 64);
      std::memset(got, 0, 64);
      if (size == 4) {
        jsimd_idct_4x4_sse2(qt, coef, rows, 0);
        idct_4x4(coef, q, &got[0][0], 8);
      } else {
        jsimd_idct_2x2_sse2(qt, coef, rows, 0);
        idct_2x2(coef, q, &got[0][0], 8);
      }
      for (int r = 0; r < size; ++r)
        bad += std::memcmp(ref[r], got[r], size) != 0;
    }
  }
  std::printf("%ld\n", bad);
  return 0;
}
"""


def test_reduced_idcts_equal_libjpeg_turbo_sse2(tmp_path):
    """Random blocks -- every coefficient, small ones, sparse ones, rows 0
    and 4 only (the 4x4 shortcut), the DC and row 0 -- through both."""
    (tmp_path / "fuzz.cc").write_text(HARNESS)
    subprocess.run(["g++", "-O2", "-std=c++17", "-w", "-I",
                    str(native.CSRC), str(tmp_path / "fuzz.cc"),
                    "-l:libjpeg.a", "-pthread", "-o",
                    str(tmp_path / "fuzz")], check=True, capture_output=True)
    out = subprocess.run([str(tmp_path / "fuzz"), "1", "200000"],
                         check=True, capture_output=True, text=True)
    assert out.stdout.split() == ["0"]
