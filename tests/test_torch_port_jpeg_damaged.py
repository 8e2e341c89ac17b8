"""The port's JPEG decoder on the files a scraped tree holds besides clean
8-bit YCbCr ones: CMYK and YCCK, cut and damaged files, arithmetic coding,
lossless files, and the kinds every reader refuses (12-bit samples).

Two references, as in the JAX package: the parser route is
``load_image_rgb`` (``cv2.imread``, cv2's bundled libjpeg-turbo), the
fused route the JAX package's ``native.decode_preproc_batch`` (the system
libjpeg, an RGB request at the DCT scale, ``ok[i]`` per file), held at
sizes that make both pick the denominators 1, 2, 4 and 8.

- CMYK and YCCK (Adobe transform 0, no Adobe segment, transform 2; 4:4:4
  and 4:2:0 with the K plane subsampled like Y; Huffman and arithmetic,
  sequential and progressive), written by a C helper compiled here against
  the system ``jpeglib.h``: bit-equal to cv2 at full scale and to
  ``IMREAD_REDUCED_COLOR_2/4/8``; the fused route refuses them, as JAX's
  libjpeg does.
- The fixtures ``voc_420_q75_500x375``, ``progressive_420_q75_160x120``
  and ``restart7_420_q90_333x251`` cut at 32 seeded offsets after the
  first scan's header, and 32 seeded single-bit flips of each one's scan
  bytes that make no marker: bit-equal on both routes (libjpeg's zero
  bits past the data, its fake symbol 0 for a bad Huffman code, the
  16-bit lanes of libjpeg-turbo's SIMD IDCTs on huge coefficients, and
  jdcoefct.c's block smoothing of a progressive file whose scans stop
  early, with the neighbour rows of libjpeg-turbo 3 on the cv2 route and
  of the system's 2.1 on the fused route).
- Restart markers missing, doubled, renumbered by 1..7 and replaced by an
  invalid marker, at four places of ``restart7``: libjpeg's resync.
- Arithmetic-coded files (SOF9, SOF10, DAC) written by the same helper
  with the system libjpeg's arithmetic encoder: sequential and
  progressive, restart intervals, grey, 4:4:4 / 4:2:2 / 4:2:0; cut too.
- 12-bit samples (SOF1, P=12) from :func:`encode_sequential`, this file's
  extended-sequential Huffman encoder, whose 8-bit output cv2 reads back
  to the pixels it was given: cv2, JAX's library and the port all refuse.
- Lossless (SOF3) from ``tools/format_files.py::lossless_jpeg_bytes``:
  predictors 1-7, point
  transforms 0-3, restart intervals, sampling factors, CMYK, 2 to 7 bits,
  cut and damaged files, read as cv2 reads them on the parser route; the
  fused route refuses them, as JAX's libjpeg 2.1 does; grey, YCbCr under
  an Adobe transform, 9 to 16 bits and arithmetic lossless (SOF11) raise,
  as cv2 refuses them.
"""

import re
import struct
import subprocess

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.data import native as jax_native
from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.tools.fixture_trees import TESTDATA
from objectdetectionpl_tpu_torch.tools.format_files import lossless_jpeg_bytes
from test_torch_port_data import jax_library  # noqa: F401
from test_torch_port_jpeg import smooth_image

REDUCED = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
           8: cv2.IMREAD_REDUCED_COLOR_8}
CUT_FIXTURES = ("voc_420_q75_500x375.jpg", "progressive_420_q75_160x120.jpg",
                "restart7_420_q90_333x251.jpg")

WRITER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

/* jw OUT W H NC JPEG_CS ADOBE QUALITY H0 V0 ARITH PROG RESTART < pixels
   NC 1 (grey), 3 (RGB) or 4 (CMYK) samples a pixel; JPEG_CS the file's
   colour space (J_COLOR_SPACE: 1 grey, 3 YCbCr, 4 CMYK, 5 YCCK); ADOBE 1
   writes the Adobe segment; H0 V0 the first component's sampling (and
   the fourth's), the others 1x1 */
int main(int argc, char** argv) {
  if (argc != 13) return 2;
  int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]);
  unsigned char* px = malloc((size_t)w * h * nc);
  if (fread(px, 1, (size_t)w * h * nc, stdin) != (size_t)w * h * nc) return 3;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* f = fopen(argv[1], "wb");
  jpeg_stdio_dest(&c, f);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, (J_COLOR_SPACE)atoi(argv[5]));
  c.write_Adobe_marker = atoi(argv[6]);
  jpeg_set_quality(&c, atoi(argv[7]), TRUE);
  for (int i = 0; i < c.num_components; ++i)
    c.comp_info[i].h_samp_factor = c.comp_info[i].v_samp_factor = 1;
  c.comp_info[0].h_samp_factor = atoi(argv[8]);
  c.comp_info[0].v_samp_factor = atoi(argv[9]);
  if (c.num_components == 4) {
    c.comp_info[3].h_samp_factor = atoi(argv[8]);
    c.comp_info[3].v_samp_factor = atoi(argv[9]);
  }
  c.arith_code = atoi(argv[10]);
  if (atoi(argv[11])) jpeg_simple_progression(&c);
  c.restart_interval = atoi(argv[12]);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(f);
  return 0;
}
"""
GRAY, YCBCR, CMYK, YCCK = 1, 3, 4, 5


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    d = tmp_path_factory.mktemp("jw")
    (d / "jw.c").write_text(WRITER)
    subprocess.run(["cc", "-O1", str(d / "jw.c"), "-ljpeg", "-o",
                    str(d / "jw")], check=True, capture_output=True)
    return str(d / "jw")


def _write(tool, path, img, cs, adobe=0, quality=85, hv=(1, 1), arith=0,
           progressive=0, restart=0):
    h, w, nc = img.shape
    subprocess.run([tool, str(path), str(w), str(h), str(nc), str(cs),
                    str(adobe), str(quality), str(hv[0]), str(hv[1]),
                    str(arith), str(progressive), str(restart)],
                   input=np.ascontiguousarray(img).tobytes(), check=True,
                   capture_output=True)
    return str(path)


def _jax_denom(w, h, target, max_denom=8):
    d = 1
    while d < max_denom and w // (2 * d) >= target and h // (2 * d) >= target:
        d *= 2
    return d


def _targets(w, h):
    """{denominator: S} making JAX's rule pick 1, 2, 4 and 8."""
    out = {}
    for s in range(min(w, h), 0, -1):
        out.setdefault(_jax_denom(w, h, s), s)
    return {d: out[d] for d in (1, 2, 4, 8)}


def _cv2_route(path):
    """The port's parser route against cv2's; True when both read it."""
    try:
        want = load_image_rgb(path)
    except OSError:
        want = None
    if want is None:
        with pytest.raises(native.ImageError, match=f"^{re.escape(path)}: "):
            native.decode_image(path)
        return False
    got = native.decode_image(path)
    assert got.shape == want.shape, path
    if not np.array_equal(got, want):
        d = np.abs(got.astype(int) - want.astype(int))
        pytest.fail(f"{path}: max |diff| {d.max()} on {np.mean(d > 0):.3%}")
    return True


def _fused_route(path, size):
    """The port's fused call against JAX's at each denominator: equal
    images, or both refuse.  Returns whether JAX's decoded it."""
    w, h = size
    oks = set()
    for d, s in _targets(w, h).items():
        want = jax_native.decode_preproc_batch([path], s, False)
        got = native.decode_preproc_codes([path], s, False,
                                          max_denom=native.MAX_DENOM)
        ok = bool(want[-1][0])
        assert (got[-1][0] == native.JPEG_OK) == ok, (path, d)
        if ok:
            np.testing.assert_array_equal(got[0], want[0],
                                          err_msg=f"{path} 1/{d}")
        oks.add(ok)
    assert len(oks) == 1, path
    return oks.pop()


# ---------------------------------------------------------------------------
# CMYK and YCCK

@pytest.mark.parametrize("cs,adobe", [(CMYK, 1), (CMYK, 0), (YCCK, 1)])
@pytest.mark.parametrize("hv", [(1, 1), (2, 2)])
@pytest.mark.parametrize("arith,progressive", [(0, 0), (0, 1), (1, 0)])
def test_cmyk_and_ycck_bit_equal(tmp_path, writer, jax_library, cs, adobe,
                                 hv, arith, progressive):
    rng = np.random.RandomState(cs * 10 + adobe + hv[0])
    for w, h in ((45, 37), (64, 48), (17, 9)):
        img = np.concatenate([smooth_image(h, w, rng),
                              smooth_image(h, w, rng, 1)], -1)
        path = _write(writer, tmp_path / f"c{w}.jpg", img, cs, adobe, 85,
                      hv, arith, progressive)
        assert _cv2_route(path)
        for denom, flag in REDUCED.items():
            want = cv2.imread(path, flag)[..., ::-1]
            got = native.decode_one(path, denom, imread=True)
            np.testing.assert_array_equal(got, want, err_msg=f"1/{denom}")
        assert not _fused_route(path, (w, h))        # libjpeg's RGB refuses
        with pytest.raises(native.JpegError, match="4 components"):
            native.decode_one(path)


# ---------------------------------------------------------------------------
# cut and damaged files

def _first_scan(data: bytes) -> int:
    sos = data.index(b"\xff\xda")
    return sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]


def _size(name):
    return tuple(int(v) for v in re.search(r"(\d+)x(\d+)", name).groups())


@pytest.mark.parametrize("name", CUT_FIXTURES)
def test_cut_files_bit_equal(tmp_path, jax_library, name):
    data = (TESTDATA / name).read_bytes()
    rng = np.random.RandomState(len(name))
    cuts = sorted(rng.randint(_first_scan(data), len(data), 32))
    read = 0
    for cut in cuts:
        path = str(tmp_path / f"cut{cut}.jpg")
        with open(path, "wb") as f:
            f.write(data[:cut])
        # read alike, or (a cut inside a later scan's header) refused alike
        read += _cv2_route(path)
        read += _fused_route(path, _size(name))
    assert read >= 48           # most cuts decode on both routes


def _scan_bytes(data: bytes) -> np.ndarray:
    """The offsets of every scan's entropy-coded bytes."""
    out, pos = [], 0
    while True:
        sos = data.find(b"\xff\xda", pos)
        if sos < 0:
            return np.concatenate(out)
        start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
        end = start
        while not (data[end] == 0xFF and data[end + 1] not in (0, 0xFF)
                   and not 0xD0 <= data[end + 1] <= 0xD7):
            end += 1
        out.append(np.arange(start, end))
        pos = end


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411"])
def test_cut_progressive_files_bit_equal(tmp_path, writer, jax_library,
                                         sampling):
    """Cut progressive files of every sampling, narrow (1-5 blocks) and
    of odd block heights, Huffman (cv2) and arithmetic-coded: the block
    smoothing's neighbour rows and columns at every edge, both routes."""
    rng = np.random.RandomState(len(sampling) + int(sampling))
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for k, (w, h) in enumerate([(12, 41), (17, 88), (33, 23), (61, 57)]):
        img = smooth_image(h, w, rng, noise=6.0)
        if k == 3:
            hv = {"444": (1, 1), "422": (2, 1)}.get(sampling, (2, 2))
            path = _write(writer, tmp_path / "a.jpg", img, YCBCR, 0, 75, hv,
                          1, 1, 0)
            data = open(path, "rb").read()
        else:
            ok, buf = cv2.imencode(".jpg", img[..., ::-1], [
                cv2.IMWRITE_JPEG_QUALITY, 70, cv2.IMWRITE_JPEG_PROGRESSIVE,
                1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
                cv2.IMWRITE_JPEG_RST_INTERVAL, k])
            data = buf.tobytes()
        for cut in rng.randint(_first_scan(data), len(data), 2):
            path = str(tmp_path / f"cut{k}_{cut}.jpg")
            with open(path, "wb") as f:
                f.write(data[:cut])
            assert _cv2_route(path) == _fused_route(path, (w, h))


def _flips(data: bytes, rng, n: int):
    """n (position, bit) single-bit flips of entropy-coded bytes that
    neither touch nor make a 0xFF, so that no marker appears or goes."""
    scan, out = _scan_bytes(data), []
    while len(out) < n:
        pos, bit = int(scan[rng.randint(len(scan))]), rng.randint(8)
        flipped = data[pos] ^ (1 << bit)
        if 0xFF not in (data[pos], data[pos - 1], flipped):
            out.append((pos, bit))
    return out


@pytest.mark.parametrize("name", CUT_FIXTURES)
def test_bit_flips_bit_equal(tmp_path, jax_library, name):
    data = (TESTDATA / name).read_bytes()
    rng = np.random.RandomState(len(name) + 1)
    differ = 0
    for pos, bit in _flips(data, rng, 32):
        damaged = bytearray(data)
        damaged[pos] ^= 1 << bit
        path = str(tmp_path / f"flip{pos}_{bit}.jpg")
        with open(path, "wb") as f:
            f.write(damaged)
        assert _cv2_route(path)
        assert _fused_route(path, _size(name))
        differ += not np.array_equal(native.decode_image(path),
                                     native.decode_one(str(TESTDATA / name)))
    assert differ > 16          # the flips did damage the images


def _restart_cases(data: bytes):
    rst = [m.start() for m in re.finditer(b"\xff[\xd0-\xd7]", data)]
    assert len(rst) > 8
    for k in (0, 3, len(rst) // 2, len(rst) - 1):
        at = rst[k]
        yield f"missing{k}", data[:at] + data[at + 2:]
        yield f"doubled{k}", data[:at] + data[at:at + 2] + data[at:]
        for delta in range(1, 8):
            d = bytearray(data)
            d[at + 1] = 0xD0 + ((data[at + 1] - 0xD0 + delta) & 7)
            yield f"renumbered{k}+{delta}", bytes(d)
        d = bytearray(data)
        d[at + 1] = 0x05                       # below SOF0: skipped
        yield f"invalid{k}", bytes(d)


def test_restart_markers_resync_as_libjpeg(tmp_path, jax_library):
    name = "restart7_420_q90_333x251.jpg"
    data = (TESTDATA / name).read_bytes()
    for label, damaged in _restart_cases(data):
        path = str(tmp_path / f"{label}.jpg")
        with open(path, "wb") as f:
            f.write(damaged)
        assert _cv2_route(path), label
        assert _fused_route(path, _size(name)), label


# ---------------------------------------------------------------------------
# arithmetic coding

@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("restart", [0, 3])
def test_arithmetic_coding_bit_equal(tmp_path, writer, jax_library,
                                     progressive, restart):
    rng = np.random.RandomState(progressive * 2 + restart)
    for w, h in ((45, 37), (160, 120), (17, 9)):
        img = smooth_image(h, w, rng)
        for hv in ((1, 1), (2, 1), (2, 2)):
            path = _write(writer, tmp_path / f"a{w}_{hv[0]}{hv[1]}.jpg", img,
                          YCBCR, 0, 80, hv, 1, progressive, restart)
            assert bytes([0xFF, 0xCA if progressive else 0xC9]) in \
                open(path, "rb").read()
            assert _cv2_route(path)
            assert _fused_route(path, (w, h))
        gray = _write(writer, tmp_path / f"g{w}.jpg",
                      smooth_image(h, w, rng, 1), GRAY, 0, 80, (1, 1), 1,
                      progressive, restart)
        assert _cv2_route(gray) and _fused_route(gray, (w, h))


def test_cut_arithmetic_files_bit_equal(tmp_path, writer, jax_library):
    rng = np.random.RandomState(11)
    img = smooth_image(120, 160, rng)
    data = open(_write(writer, tmp_path / "a.jpg", img, YCBCR, 0, 80, (2, 2),
                       1, 0, 2), "rb").read()
    for cut in sorted(rng.randint(_first_scan(data), len(data), 12)):
        path = str(tmp_path / f"cut{cut}.jpg")
        with open(path, "wb") as f:
            f.write(data[:cut])
        assert _cv2_route(path)
        assert _fused_route(path, (160, 120))


# ---------------------------------------------------------------------------
# 12-bit and lossless files, from this file's encoders

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
_DCT = np.array([[np.sqrt((1 if k == 0 else 2) / 8)
                  * np.cos((2 * n + 1) * k * np.pi / 16) for n in range(8)]
                 for k in range(8)])


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = self.acc << 1 | (value >> i) & 1
            self.n += 1
            if self.n == 8:
                self.out += bytes([self.acc]) + (b"\x00" if self.acc == 0xFF
                                                 else b"")
                self.acc = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _category(v: int) -> int:
    return abs(int(v)).bit_length()


def _magnitude(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


def encode_sequential(img: np.ndarray, precision: int = 12,
                      q: int = 2) -> bytes:
    """A grey or 3-component (stored as is, i.e. YCbCr) image of samples
    in [0, 2**precision) -> an extended-sequential (SOF1) Huffman JPEG at
    that precision: float DCT, one flat quantizer ``q`` (16-bit DQT), DC
    categories 0..15 coded in 5 bits, every AC (run, size) and EOB/ZRL in 8
    bits."""
    img = np.asarray(img, np.int64)
    img = img[..., None] if img.ndim == 2 else img
    h, w, nc = img.shape
    dc_code = {s: (s, 5) for s in range(16)}
    ac_syms = sorted([0x00, 0xF0] + [r << 4 | s for r in range(16)
                                     for s in range(1, 15)])
    ac_code = {s: (i, 8) for i, s in enumerate(ac_syms)}
    pad = np.pad(img, ((0, -h % 8), (0, -w % 8), (0, 0)), mode="edge")
    bits, pred = _Bits(), [0] * nc
    for by in range(0, pad.shape[0], 8):
        for bx in range(0, pad.shape[1], 8):
            for c in range(nc):
                block = pad[by:by + 8, bx:bx + 8, c] - (1 << precision - 1)
                coef = np.round((_DCT @ block @ _DCT.T).reshape(-1)[_ZIGZAG]
                                / q).astype(np.int64)
                diff, pred[c] = int(coef[0]) - pred[c], int(coef[0])
                s = _category(diff)
                bits.put(*dc_code[s])
                bits.put(_magnitude(diff, s), s)
                nz = [k for k in range(1, 64) if coef[k]]
                run = 0
                for k in range(1, (nz[-1] if nz else 0) + 1):
                    if not coef[k]:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac_code[0xF0])
                        run -= 16
                    s = _category(coef[k])
                    bits.put(*ac_code[run << 4 | s])
                    bits.put(_magnitude(int(coef[k]), s), s)
                    run = 0
                if not nz or nz[-1] < 63:
                    bits.put(*ac_code[0x00])
    dc_bits, ac_bits = bytearray(16), bytearray(16)
    dc_bits[4], ac_bits[7] = 16, len(ac_syms)
    return (b"\xff\xd8"
            + _segment(0xDB, b"\x10" + struct.pack(">64H", *[q] * 64))
            + _segment(0xC1, bytes([precision]) + struct.pack(">HH", h, w)
                       + bytes([nc]) + b"".join(bytes([c + 1, 0x11, 0])
                                                for c in range(nc)))
            + _segment(0xC4, b"\x00" + bytes(dc_bits) + bytes(range(16))
                       + b"\x10" + bytes(ac_bits) + bytes(ac_syms))
            + _segment(0xDA, bytes([nc]) + b"".join(bytes([c + 1, 0])
                                                    for c in range(nc))
                       + b"\x00\x3f\x00")
            + bits.flush() + b"\xff\xd9")


def test_sequential_encoder_is_read_by_cv2(tmp_path):
    """At 8 bits and q=1 the encoder's file decodes to the samples given
    (within the DCT's rounding), by cv2 and the port alike."""
    rng = np.random.RandomState(2)
    img = smooth_image(24, 30, rng, 1)[..., 0]
    path = tmp_path / "e8.jpg"
    path.write_bytes(encode_sequential(img, precision=8, q=1))
    got = load_image_rgb(str(path))
    assert np.abs(got[..., 0].astype(int) - img).max() <= 1
    np.testing.assert_array_equal(native.decode_image(str(path)), got)


@pytest.mark.parametrize("components", [1, 3])
def test_12_bit_files_are_refused_by_every_reader(tmp_path, jax_library,
                                                  components):
    rng = np.random.RandomState(components)
    img = rng.randint(0, 4096, (16, 24, components))
    path = str(tmp_path / "p12.jpg")
    with open(path, "wb") as f:
        f.write(encode_sequential(img))
    assert cv2.imread(path) is None
    assert not jax_native.decode_preproc_batch([path], 8, False)[-1][0]
    assert not _cv2_route(path)
    with pytest.raises(native.JpegError, match="12-bit samples"):
        native.decode_image(path)
    codes = native.decode_preproc_codes([path], 8, False, max_denom=8)[-1]
    assert codes[0] == 2                            # JPEG_UNSUPPORTED


def test_lossless_is_read_by_cv2_and_refused_by_the_port(tmp_path,
                                                         jax_library):
    """cv2's libjpeg-turbo 3 reads a lossless file and so does the port's
    parser route; the fused route refuses it, as the system libjpeg 2.1
    of JAX's fused loader does, so its batch takes the parser route."""
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (5, 7, 3))
    path = str(tmp_path / "lossless.jpg")
    with open(path, "wb") as f:
        f.write(lossless_jpeg_bytes(img))
    assert load_image_rgb(path).shape == (5, 7, 3)
    assert not jax_native.decode_preproc_batch([path], 4, False)[-1][0]
    codes = native.decode_preproc_codes([path], 4, False, max_denom=8)[-1]
    assert codes[0] == 2                            # JPEG_UNSUPPORTED
    with pytest.raises(native.JpegError,
                       match=f"^{re.escape(path)}: lossless JPEG"):
        native.decode_one(path)
    assert _cv2_route(path)
    np.testing.assert_array_equal(native.decode_image(path), img)


def _lossless_case(tmp_path, data, name="ll.jpg"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return _cv2_route(path)


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("al", range(4))
def test_lossless_predictors_and_point_transforms(tmp_path, psv, al):
    rng = np.random.RandomState(psv * 4 + al)
    img = smooth_image(13, 17, rng, 3)
    for restart_rows in (0, 1, 3):
        assert _lossless_case(tmp_path, lossless_jpeg_bytes(
            img, psv=psv, al=al, restart_rows=restart_rows))


# (sampling of the 3 components, restart rows, predictor); each plane is
# ceil(H h / Hmax) x ceil(W v / Vmax) samples of an 11 x 13 image
LOSSLESS_SAMPLING = [([(2, 2), (1, 1), (1, 1)], 0, 1),
                     ([(2, 2), (1, 1), (1, 1)], 1, 6),
                     ([(2, 2), (1, 1), (1, 1)], 2, 7),
                     ([(2, 1), (1, 1), (1, 1)], 1, 5),
                     ([(1, 2), (1, 1), (1, 1)], 0, 4),
                     ([(1, 1), (2, 2), (1, 1)], 3, 2)]


@pytest.mark.parametrize("sampling,restart_rows,psv", LOSSLESS_SAMPLING)
def test_lossless_sampling_factors(tmp_path, sampling, restart_rows, psv):
    rng = np.random.RandomState(psv)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    planes = [rng.randint(0, 256, (-(-11 * v // vmax), -(-13 * h // hmax)))
              for h, v in sampling]
    assert _lossless_case(tmp_path, lossless_jpeg_bytes(
        planes, psv=psv, restart_rows=restart_rows, sampling=sampling,
        size=(11, 13)))


# what cv2 refuses (libjpeg-turbo converts no colour space of a lossless
# file, reads 2 to 8 bits with its 8-bit interface, and has no arithmetic
# lossless decoder) and what it reads
ADOBE = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"


@pytest.mark.parametrize("kind,read", [
    ("grey", False), ("cmyk", True), ("ycbcr_adobe", False),
    ("rgb_adobe", True), ("p2", True), ("p5", True), ("p7", True),
    ("p9", False), ("p12", False), ("p16", False), ("sof11", False),
    ("out_of_range", True), ("out_of_range_al2", True)])
def test_lossless_kinds(tmp_path, kind, read):
    rng = np.random.RandomState(len(kind))
    img = rng.randint(0, 256, (9, 11, 3))
    if kind == "grey":
        data = lossless_jpeg_bytes(img[..., 0])
    elif kind == "cmyk":
        data = lossless_jpeg_bytes(rng.randint(0, 256, (6, 5, 4)))
    elif kind.endswith("_adobe"):
        data = lossless_jpeg_bytes(img, app=ADOBE + bytes(
            [kind == "ycbcr_adobe"]))
    elif kind.startswith("p"):
        bits = int(kind[1:])
        data = lossless_jpeg_bytes(rng.randint(0, 1 << bits, (9, 11, 3)),
                               precision=bits, al=1)
    elif kind == "sof11":
        data = bytearray(lossless_jpeg_bytes(img))
        data[data.index(b"\xff\xc3") + 1] = 0xCB
        data = bytes(data)
    else:                                   # 16-bit samples, 8-bit output
        data = lossless_jpeg_bytes(rng.randint(0, 65536, (7, 9, 3)),
                               al=2 if kind.endswith("al2") else 0)
    assert _lossless_case(tmp_path, data) == read


@pytest.mark.parametrize("seed", range(4))
def test_lossless_cut_and_damaged(tmp_path, seed):
    """Cut at 8 offsets and 8 bit flips of the scan data, with restarts:
    libjpeg's zero differences after the data ran out, each such row
    predicted afresh, and its resync."""
    rng = np.random.RandomState(seed)
    data = lossless_jpeg_bytes(smooth_image(20, 24, rng, 3), psv=1 + seed,
                           restart_rows=seed)
    scan = data.index(b"\xff\xda") + 14
    for cut in rng.randint(scan, len(data), 8):
        assert _lossless_case(tmp_path, data[:cut])
    for _ in range(8):
        flipped = bytearray(data)
        flipped[rng.randint(scan, len(data) - 2)] ^= 1 << rng.randint(8)
        _lossless_case(tmp_path, bytes(flipped))


def test_formats_fixtures_match_recipe(tmp_path, writer):
    """The committed YCCK and arithmetic-coded fixtures of
    ``data/testdata/formats/`` are the system libjpeg's output of this
    file's writer on the progressive fixture's decode (the YCCK file from
    255 - RGB and K = 255 - max(R, G, B)); a libjpeg that encodes otherwise
    breaks this test, not the decoder."""
    rgb = native.decode_one(str(TESTDATA / "progressive_420_q75_160x120.jpg"))
    k = 255 - rgb.max(-1, keepdims=True)
    cmyk = np.concatenate([255 - rgb, k], -1).astype(np.uint8)
    recipe = {"ycck_420_q85_160x120.jpg": (cmyk, YCCK, 1, 85, 0, 0, 0),
              "arith_420_q80_160x120.jpg": (rgb, YCBCR, 0, 80, 1, 0, 4),
              "arith_progressive_420_q80_160x120.jpg":
                  (rgb, YCBCR, 0, 80, 1, 1, 0)}
    formats_dir = TESTDATA / "formats"
    assert sorted(p.name for p in formats_dir.glob("*.jpg")) == \
        sorted(recipe)
    for name, (img, cs, adobe, q, arith, prog, rst) in recipe.items():
        path = _write(writer, tmp_path / name, img, cs, adobe, q, (2, 2),
                      arith, prog, rst)
        assert open(path, "rb").read() == (formats_dir / name).read_bytes()
        assert _cv2_route(str(formats_dir / name))
