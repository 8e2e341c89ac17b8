"""The port's JPEG decoder (``csrc/jpeg_decode.cc`` through ``data/native.py``)
against libjpeg-turbo.

The reference is the JAX package's ``parsers/common.py::load_image_rgb``,
which here is ``cv2.imread`` (libjpeg-turbo's default decompression, RGB
order); every baseline case must equal it bit for bit.  Where PIL's
libjpeg-turbo gives another image, the test says so and holds to cv2.
Cases: the committed fixtures under ``data/testdata/`` (made by
:func:`make_fixtures`, whose output the first test holds against the
committed bytes and decoded hashes), PIL-made files over subsampling,
quality, size and Huffman optimisation, cv2-made files with restart
intervals and every sampling layout cv2 writes, grayscale, the colour-space
rules (an Adobe marker with transform 0, component ids 'R','G','B'), 16-bit
quantization tables under SOF1, fill bytes before markers; and the files
that must raise, naming the path; the committed CMYK fixture, a drawn
CMYK file and a cut file, which decode as cv2 decodes them (the damaged
and CMYK/YCCK cases at large are in ``test_torch_port_jpeg_damaged.py``).
Progressive files, scan scripts and the reduced scales are in
``test_torch_port_progressive.py``.
"""

import hashlib
import io
import itertools
import json
import re
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.tools.fixture_trees import (BDD_FRAMES,
                                                            HASHES, TESTDATA,
                                                            UNSUPPORTED)


def smooth_image(h: int, w: int, rng, channels: int = 3,
                 noise: float = 3.0) -> np.ndarray:
    """Smooth synthetic content (sinusoids and a few soft discs) with mild
    Gaussian noise, uint8 [h, w, channels]."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((h, w, channels), np.float32)
    for k in range(channels):
        a, b = rng.uniform(0.005, 0.05, 2)
        p, q = rng.uniform(0, 2 * np.pi, 2)
        out[..., k] = 128 + 70 * np.sin(a * x + p) * np.cos(b * y + q)
    for _ in range(3):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.1, 0.3) * max(h, w)
        disc = np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * r * r))
        out += disc[..., None] * rng.uniform(-60, 60, channels)
    out += rng.normal(0, noise, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def _pil(path, img, **kw):
    Image.fromarray(img if img.shape[-1] == 3 else img[..., 0]).save(
        path, "JPEG", **kw)


def _cv2(path, img, params):
    ok = cv2.imwrite(str(path), np.ascontiguousarray(img[..., ::-1]), params)
    assert ok, path


# name -> (size (w, h), channels, writer); seeded in this order
FIXTURES = {
    "voc_420_q75_500x375.jpg": ((500, 375), 3, lambda p, im: _pil(
        p, im, quality=75, subsampling=2)),
    "coco_420_q75_640x480.jpg": ((640, 480), 3, lambda p, im: _pil(
        p, im, quality=75, subsampling=2)),
    "full_444_q95_320x240.jpg": ((320, 240), 3, lambda p, im: _pil(
        p, im, quality=95, subsampling=0)),
    "h2v1_422_q85_256x192.jpg": ((256, 192), 3, lambda p, im: _pil(
        p, im, quality=85, subsampling=1)),
    "gray_q85_200x150.jpg": ((200, 150), 1, lambda p, im: _pil(
        p, im, quality=85)),
    "odd_420_q75_37x53.jpg": ((37, 53), 3, lambda p, im: _pil(
        p, im, quality=75, subsampling=2)),
    "optimized_420_q80_320x240.jpg": ((320, 240), 3, lambda p, im: _pil(
        p, im, quality=80, subsampling=2, optimize=True)),
    "restart7_420_q90_333x251.jpg": ((333, 251), 3, lambda p, im: _cv2(
        p, im, [cv2.IMWRITE_JPEG_QUALITY, 90,
                cv2.IMWRITE_JPEG_RST_INTERVAL, 7])),
    "progressive_420_q75_160x120.jpg": ((160, 120), 3, lambda p, im: _pil(
        p, im, quality=75, subsampling=2, progressive=True)),
    "cmyk_q90_56x40.jpg": ((56, 40), 3, lambda p, im: Image.fromarray(
        im).convert("CMYK").save(p, "JPEG", quality=90)),
    "bdd_420_q75_1280x720.jpg": ((1280, 720), 3, lambda p, im: _pil(
        p, im, quality=75, subsampling=2)),
    "bdd_progressive_420_q75_1280x720.jpg": ((1280, 720), 3,
                                             lambda p, im: _pil(
        p, im, quality=75, subsampling=2, progressive=True)),
}
DECODABLE = [n for n in FIXTURES if n not in UNSUPPORTED]
REDUCED = {2: cv2.IMREAD_REDUCED_COLOR_2, 4: cv2.IMREAD_REDUCED_COLOR_4,
           8: cv2.IMREAD_REDUCED_COLOR_8}


def make_fixtures(out_dir, seed: int = 0) -> None:
    """The recipe of the committed fixtures: each image drawn from one
    numpy generator in FIXTURES' order, written by PIL or cv2."""
    rng = np.random.RandomState(seed)
    for name, ((w, h), channels, write) in FIXTURES.items():
        write(Path(out_dir) / name, smooth_image(h, w, rng, channels))


def _entry(rgb: np.ndarray) -> dict:
    return {"shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def libjpeg_hashes(directory) -> dict:
    """{name: {"shape": [h, w, 3], "sha256": ...}} of cv2's RGB decodes of
    the decodable fixtures; the 1280x720 frames also hold "scaled": {d:
    {"shape", "sha256"}} of cv2's decodes at 1/d (libjpeg's scale_denom)."""
    out = {}
    for name in DECODABLE:
        path = str(Path(directory) / name)
        out[name] = _entry(load_image_rgb(path))
        if name in BDD_FRAMES:
            out[name]["scaled"] = {
                str(d): _entry(cv2.imread(path, flag)[..., ::-1])
                for d, flag in REDUCED.items()}
    return out


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _assert_equal_to_libjpeg(path):
    ref = load_image_rgb(str(path))
    got = native.decode_one(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape, path
    if not np.array_equal(got, ref):
        d = np.abs(got.astype(int) - ref.astype(int))
        pytest.fail(f"{path}: max |diff| {d.max()} on {np.mean(d > 0):.2%} "
                    f"of samples")
    pil = np.asarray(Image.open(path).convert("RGB"))
    return np.array_equal(pil, ref)     # cv2 and PIL agree


def test_fixtures_match_recipe(tmp_path):
    make_fixtures(tmp_path)
    committed = sorted(p.name for p in TESTDATA.glob("*.jpg"))
    assert committed == sorted(FIXTURES)
    assert sum(p.stat().st_size for p in TESTDATA.glob("*.jpg")) < 400_000
    for name in FIXTURES:
        assert _sha(tmp_path / name) == _sha(TESTDATA / name), name
    assert json.loads(HASHES.read_text()) == libjpeg_hashes(TESTDATA)


@pytest.mark.parametrize("name", DECODABLE)
def test_fixture_bit_equal(name):
    assert _assert_equal_to_libjpeg(TESTDATA / name)
    want = json.loads(HASHES.read_text())[name]
    got = native.decode_one(str(TESTDATA / name))
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]


@pytest.mark.parametrize("subsampling,quality",
                         itertools.product((0, 1, 2), (30, 75, 95)))
def test_pil_baseline_bit_equal(tmp_path, subsampling, quality):
    rng = np.random.RandomState(100 + 3 * subsampling + quality)
    for (w, h), optimize in itertools.product(
            [(1, 1), (8, 8), (17, 9), (37, 53), (64, 48)], (False, True)):
        path = tmp_path / f"{w}x{h}_{int(optimize)}.jpg"
        _pil(path, smooth_image(h, w, rng, noise=12.0), quality=quality,
             subsampling=subsampling, optimize=optimize)
        _assert_equal_to_libjpeg(path)


@pytest.mark.parametrize("interval", [1, 7])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411"])
def test_cv2_restart_intervals_bit_equal(tmp_path, interval, sampling):
    """Restart markers every 1 or 7 MCUs (7: in the middle of MCU rows),
    under each sampling layout cv2 writes: 4:4:0 takes libjpeg-turbo's h1v2
    fancy upsampling, 4:1:1 the box replication."""
    rng = np.random.RandomState(interval * 10 + len(sampling))
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for w, h in [(37, 53), (64, 48), (131, 77)]:
        path = tmp_path / f"{w}x{h}.jpg"
        _cv2(path, smooth_image(h, w, rng, noise=8.0),
             [cv2.IMWRITE_JPEG_QUALITY, 85,
              cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
        _assert_equal_to_libjpeg(path)


@pytest.mark.parametrize("writer", ["pil", "cv2_restart"])
def test_grayscale_bit_equal(tmp_path, writer):
    rng = np.random.RandomState(7)
    for w, h in [(1, 1), (37, 53), (64, 48)]:
        img = smooth_image(h, w, rng, channels=1, noise=8.0)
        path = tmp_path / f"{w}x{h}.jpg"
        if writer == "pil":
            _pil(path, img, quality=80)
        else:
            assert cv2.imwrite(str(path), img[..., 0],
                               [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
        _assert_equal_to_libjpeg(path)
        got = native.decode_one(str(path))
        assert (got == got[..., :1]).all()     # replicated to three channels


def _segments(data: bytes):
    """(marker, start, end) of each marker segment before the scan data."""
    i, out = 2, []
    while True:
        m = data[i + 1]
        n = int.from_bytes(data[i + 2:i + 4], "big")
        out.append((m, i, i + 2 + n))
        if m == 0xDA:
            return out
        i += 2 + n


def _retag(src: bytes, app: bytes, ids: bytes) -> bytes:
    """``src`` without its JFIF APP0, with ``app`` in its place and the
    frame's and scan's component ids set to ``ids``."""
    out = bytearray(src)
    for m, a, b in reversed(_segments(src)):
        if m == 0xC0:
            for k in range(3):
                out[a + 10 + 3 * k] = ids[k]
        elif m == 0xDA:
            for k in range(3):
                out[a + 5 + 2 * k] = ids[k]
        elif m == 0xE0:
            out[a:b] = app
    return bytes(out)


@pytest.mark.parametrize("rule", ["adobe_rgb", "rgb_ids", "adobe_ycc"])
def test_colour_space_rules(tmp_path, rule):
    """libjpeg's default colour space for 3 components without JFIF: an
    Adobe marker's transform (0: RGB, 1: YCbCr), else the component ids."""
    rng = np.random.RandomState(3)
    path = tmp_path / "src.jpg"
    _pil(path, smooth_image(48, 40, rng), quality=90, subsampling=0)
    adobe = lambda t: (b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
                       + bytes([t]))
    data = {"adobe_rgb": _retag(path.read_bytes(), adobe(0), b"\x01\x02\x03"),
            "rgb_ids": _retag(path.read_bytes(), b"", b"RGB"),
            "adobe_ycc": _retag(path.read_bytes(), adobe(1), b"RGB")}[rule]
    out = tmp_path / f"{rule}.jpg"
    out.write_bytes(data)
    _assert_equal_to_libjpeg(out)
    converted = rule == "adobe_ycc"
    assert np.array_equal(native.decode_one(str(out)),
                          native.decode_one(str(path))) == converted


@pytest.mark.parametrize("step", [300, 1000])
def test_extended_16bit_tables_bit_equal(tmp_path, step):
    """Quantizers above 255 make libjpeg write 16-bit DQT tables under an
    SOF1 (extended sequential) frame."""
    rng = np.random.RandomState(step)
    path = tmp_path / "q16.jpg"
    _pil(path, smooth_image(48, 64, rng, noise=12.0), subsampling=2,
         qtables=[[step] * 64, [step] * 64])
    data = path.read_bytes()
    assert b"\xff\xc1" in data and data[data.index(b"\xff\xdb") + 4] >> 4
    _assert_equal_to_libjpeg(path)


def test_fill_bytes_before_markers(tmp_path):
    """0xFF fill bytes before every RSTn and before EOI."""
    src = (TESTDATA / "restart7_420_q90_333x251.jpg").read_bytes()
    scan = src.index(b"\xff\xda")
    body = bytearray(src[:scan])
    rest = src[scan:]
    for i, c in enumerate(rest):
        if c == 0xFF and i + 1 < len(rest) and (
                0xD0 <= rest[i + 1] <= 0xD7 or rest[i + 1] == 0xD9):
            body += b"\xff\xff"
        body.append(c)
    path = tmp_path / "fill.jpg"
    path.write_bytes(bytes(body))
    _assert_equal_to_libjpeg(path)


def _bad_files(tmp_path):
    rng = np.random.RandomState(5)
    img = smooth_image(40, 56, rng)
    files = {}
    files["cmyk_fixture"] = TESTDATA / UNSUPPORTED[0]
    files["cmyk"] = tmp_path / "cmyk.jpg"
    Image.fromarray(img).convert("CMYK").save(files["cmyk"], "JPEG")
    files["truncated"] = tmp_path / "truncated.jpg"
    data = (TESTDATA / "voc_420_q75_500x375.jpg").read_bytes()
    files["truncated"].write_bytes(data[:len(data) // 2])
    files["header_cut"] = tmp_path / "header_cut.jpg"
    files["header_cut"].write_bytes(data[:100])
    files["not_jpeg"] = tmp_path / "not_jpeg.jpg"
    files["not_jpeg"].write_bytes(b"\x89PNG\r\n\x1a\n not a jpeg")
    files["missing"] = tmp_path / "missing.jpg"
    return files


@pytest.mark.parametrize("kind,reason", [
    ("cmyk_fixture", "4 components \\(CMYK or YCCK\\)"),
    ("cmyk", "4 components"),
    ("header_cut", "truncated file"), ("not_jpeg", "not a JPEG file"),
    ("missing", "cannot read the file")])
def test_unsupported_and_broken_files_raise(tmp_path, kind, reason):
    """Files that libjpeg's RGB output refuses (CMYK, which cv2.imread reads
    and the cv2 route decodes: ``test_cmyk_and_truncated_files_decode``),
    and files that every route refuses."""
    path = str(_bad_files(tmp_path)[kind])
    pattern = f"^{re.escape(path)}: .*{reason}"
    with pytest.raises(native.JpegError, match=pattern):
        native.decode_one(path)
    with pytest.raises(native.JpegError, match=pattern):
        native.decode_batch([str(TESTDATA / DECODABLE[0]), path])
    with pytest.raises(native.JpegError, match=pattern):
        native.decode_preproc_batch([str(TESTDATA / DECODABLE[0]), path],
                                    64, False)
    if not kind.startswith("cmyk"):
        with pytest.raises(native.JpegError, match=pattern):
            native.decode_one(path, imread=True)


@pytest.mark.parametrize("kind", ["cmyk_fixture", "cmyk", "truncated"])
def test_cmyk_and_truncated_files_decode(tmp_path, kind):
    """The CMYK files and a file cut at half its bytes decode as cv2.imread
    decodes them (the JAX package's ``load_image_rgb``); the cut file's
    missing rows are libjpeg's mid-grey."""
    path = _bad_files(tmp_path)[kind]
    got = native.decode_one(str(path), imread=True)
    np.testing.assert_array_equal(got, load_image_rgb(str(path)))
    if kind == "truncated":
        assert (got[-8:] == 128).all()
        np.testing.assert_array_equal(native.decode_one(str(path)), got)


def test_decode_batch_equals_decode_one(tmp_path):
    paths = [str(TESTDATA / n) for n in DECODABLE]
    assert len(paths) == 11
    batch = native.decode_batch(paths, threads=3)
    assert len(batch) == 11
    for p, img in zip(paths, batch):
        assert np.array_equal(img, native.decode_one(p)), p
    assert native.decode_batch([]) == []


def test_decoder_builds_under_build():
    assert native.available() and native.build_error is None
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR and lib.exists()
