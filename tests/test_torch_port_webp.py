"""WebP files through the port's reader (``csrc/webp_decode.cc`` and
``data/formats.py::read_webp``) against the JAX package's
``load_image_rgb`` (``cv2.imread``, cv2's bundled libwebp), bit for bit,
each file under its own name and under a ``.jpg`` name.

- ``cv2.imwrite`` at qualities 0..100 (VP8) and its default lossless VP8L,
  at 1x1, 7x5, 17x33, 64x64 and 161x121, of flat, gradient, noise and
  grey content;
- the system libwebp's encoder through a C helper compiled here against
  ``webp/encode.h``: 1-4 segments, 1/2/4/8 token partitions, the simple
  and the normal loop filter at every sharpness, methods 0-6, palettes of
  2, 4 and 16 colours (colour indexing with bundled pixels),
  near-lossless, alpha (VP8X + ALPH, and VP8L's own);
- VP8X: EXIF orientations (the first EXIF chunk, with the flag only), ICC,
  XMP and unknown chunks, a canvas that is not the image's size; ALPH
  chunks damaged, cut or with bad headers, which libwebp decodes for
  cv2's BGRA output and fails on;
- animations: the first frame on a transparent black canvas, and the
  structures libwebp's demuxer refuses;
- files cut inside their bitstream and single-bit flips.
"""

import struct
import subprocess

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.parsers import common

ENCODER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <webp/encode.h>

/* we OUT W H NC LOSSLESS QUALITY METHOD SEGMENTS PARTITIONS FILTER_TYPE
      FILTER_STRENGTH SHARPNESS SNS NEAR_LOSSLESS EXACT < pixels */
int main(int argc, char** argv) {
  if (argc != 16) return 2;
  int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]);
  size_t n = (size_t)w * h * nc;
  unsigned char* px = malloc(n);
  if (fread(px, 1, n, stdin) != n) return 3;
  WebPConfig c;
  if (!WebPConfigInit(&c)) return 4;
  c.lossless = atoi(argv[5]);
  c.quality = (float)atof(argv[6]);
  c.method = atoi(argv[7]);
  c.segments = atoi(argv[8]);
  c.partitions = atoi(argv[9]);
  c.filter_type = atoi(argv[10]);
  c.filter_strength = atoi(argv[11]);
  c.filter_sharpness = atoi(argv[12]);
  c.sns_strength = atoi(argv[13]);
  c.near_lossless = atoi(argv[14]);
  c.exact = atoi(argv[15]);
  c.autofilter = 0;
  if (!WebPValidateConfig(&c)) return 5;
  WebPPicture p;
  if (!WebPPictureInit(&p)) return 6;
  p.width = w;
  p.height = h;
  p.use_argb = c.lossless;
  if (!(nc == 4 ? WebPPictureImportRGBA(&p, px, w * 4)
                : WebPPictureImportRGB(&p, px, w * 3))) return 7;
  WebPMemoryWriter wr;
  WebPMemoryWriterInit(&wr);
  p.writer = WebPMemoryWrite;
  p.custom_ptr = &wr;
  if (!WebPEncode(&c, &p)) return 8;
  FILE* f = fopen(argv[1], "wb");
  fwrite(wr.mem, 1, wr.size, f);
  fclose(f);
  return 0;
}
"""

SETTINGS = ("method", "segments", "partitions", "filter_type",
            "filter_strength", "sharpness", "sns", "near_lossless", "exact")
DEFAULTS = dict(method=4, segments=4, partitions=0, filter_type=1,
                filter_strength=60, sharpness=0, sns=50, near_lossless=100,
                exact=0)


@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    d = tmp_path_factory.mktemp("we")
    (d / "we.c").write_text(ENCODER)
    subprocess.run(["cc", "-O1", str(d / "we.c"), "-lwebp", "-o",
                    str(d / "we")], check=True, capture_output=True)
    return str(d / "we")


def encode(tool, tmp_path, img, lossless=0, quality=75, **kw):
    """RGB or RGBA uint8 -> WebP bytes from the system libwebp."""
    args = {**DEFAULTS, **kw}
    h, w, nc = img.shape
    out = tmp_path / "enc.webp"
    subprocess.run([tool, str(out), str(w), str(h), str(nc), str(lossless),
                    str(quality)] + [str(args[k]) for k in SETTINGS],
                   input=np.ascontiguousarray(img, np.uint8).tobytes(),
                   check=True, capture_output=True)
    return out.read_bytes()


def chunks(data: bytes):
    pos, out = 12, []
    while pos + 8 <= len(data):
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _pad(tag, body):
    return (tag + struct.pack("<I", len(body)) + body
            + (b"\0" if len(body) & 1 else b""))


def riff(parts) -> bytes:
    body = b"WEBP" + b"".join(_pad(t, d) for t, d in parts)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _le24(v):
    return struct.pack("<I", v)[:3]


def vp8x(w, h, flags):
    return (b"VP8X", struct.pack("<I", flags) + _le24(w - 1) + _le24(h - 1))


def exif(orientation):
    return (b"EXIF", b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHIHH", 0x112, 3, 1, orientation, 0) + bytes(4))


ANIM = (b"ANIM", struct.pack("<IH", 0xFF102030, 0))


def anmf(x, y, w, h, flags, *frame):
    return (b"ANMF", _le24(x // 2) + _le24(y // 2) + _le24(w - 1)
            + _le24(h - 1) + _le24(100) + bytes([flags])
            + b"".join(_pad(t, d) for t, d in frame))


def content(h, w, kind, seed=0):
    y, x = np.mgrid[0:h, 0:w]
    if kind == "flat":
        return np.broadcast_to(np.uint8([30, 140, 220]), (h, w, 3)).copy()
    if kind == "gradient":
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         (x + y) * 127 // max(w + h - 2, 1)], -1).astype(
                             np.uint8)
    if kind == "noise":
        return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
            np.uint8)
    g = (np.sin(x / 5.0) * 60 + np.cos(y / 7.0) * 50 + 128).astype(np.uint8)
    return np.stack([g] * 3, -1)


def mixed(h=121, w=161):
    """Grey waves with a noise patch: smooth and busy macroblocks, both
    intra sizes and every 4x4 mode."""
    img = content(h, w, "grey")
    img[h // 3:2 * h // 3, w // 3:3 * w // 4] = content(
        2 * h // 3 - h // 3, 3 * w // 4 - w // 3, "noise", 1)
    return img


def like_cv2(tmp_path, data: bytes, name="img") -> bool:
    """The port reads ``data`` as cv2 does, under a .webp and a .jpg
    name, through ``native.decode_image`` and the port's
    ``load_image_rgb``; True when cv2 reads it, else both raise."""
    read = None
    for ext in (".webp", ".jpg"):
        path = tmp_path / f"{name}{ext}"
        path.write_bytes(data)
        try:
            ref = load_image_rgb(str(path))
        except OSError:
            ref = None
        if ref is None:
            for fn in (native.decode_image, common.load_image_rgb):
                with pytest.raises(native.ImageError,
                                   match=f"^{path}: WebP: "):
                    fn(str(path))
        else:
            for fn in (native.decode_image, common.load_image_rgb):
                got = fn(str(path))
                assert got.dtype == np.uint8 and got.shape == ref.shape
                np.testing.assert_array_equal(got, ref, err_msg=str(path))
        assert read in (None, ref is not None)
        read = ref is not None
    return read


SIZES = ((1, 1), (7, 5), (17, 33), (64, 64), (161, 121))
KINDS = ("flat", "gradient", "noise", "grey")


@pytest.mark.parametrize("quality", [0, 5, 25, 50, 75, 90, 100, "lossless"])
def test_cv2_imwrite(tmp_path, quality):
    params = [] if quality == "lossless" else [cv2.IMWRITE_WEBP_QUALITY,
                                               quality]
    for h, w in SIZES:
        for kind in KINDS:
            img = content(h, w, kind)
            path = tmp_path / "w.webp"
            assert cv2.imwrite(str(path), img[..., ::-1], params)
            tag = chunks(path.read_bytes())[0][0]
            assert tag == (b"VP8L" if quality == "lossless" else b"VP8 ")
            assert like_cv2(tmp_path, path.read_bytes())


@pytest.mark.parametrize("segments", [1, 2, 3, 4])
def test_segments_and_partitions(tmp_path, encoder, segments):
    for partitions in range(4):
        assert like_cv2(tmp_path, encode(encoder, tmp_path, mixed(),
                                         quality=60, segments=segments,
                                         partitions=partitions, sns=80))


@pytest.mark.parametrize("filter_type", [0, 1])    # simple, normal
def test_loop_filters_and_sharpness(tmp_path, encoder, filter_type):
    for sharpness in range(8):
        for strength in (0, 30, 100):
            assert like_cv2(tmp_path, encode(
                encoder, tmp_path, mixed(64, 80), quality=40,
                filter_type=filter_type, filter_strength=strength,
                sharpness=sharpness))


@pytest.mark.parametrize("lossless", [0, 1])
def test_methods(tmp_path, encoder, lossless):
    for method in range(7):
        assert like_cv2(tmp_path, encode(encoder, tmp_path, mixed(48, 70),
                                         lossless, 70, method=method))


@pytest.mark.parametrize("colours", [2, 4, 16, 200])
def test_palettes(tmp_path, encoder, colours):
    """Colour indexing: 8, 4 or 2 pixels bundled in one, or none."""
    rng = np.random.RandomState(colours)
    palette = rng.randint(0, 256, (colours, 3)).astype(np.uint8)
    index = (content(37, 53, "gradient")[..., 0].astype(int) * colours // 256
             + rng.randint(0, 2, (37, 53))) % colours
    assert like_cv2(tmp_path, encode(encoder, tmp_path, palette[index], 1))


@pytest.mark.parametrize("near", [0, 20, 40, 60, 80])
def test_near_lossless(tmp_path, encoder, near):
    assert like_cv2(tmp_path, encode(encoder, tmp_path, mixed(), 1,
                                     near_lossless=near))


def _rgba(h, w, seed=3):
    alpha = np.random.RandomState(seed).randint(0, 256, (h, w, 1))
    return np.concatenate([content(h, w, "gradient"), alpha.astype(np.uint8)],
                          -1)


def test_alpha(tmp_path, encoder):
    """VP8X + ALPH (lossless-coded alpha) + VP8 at three qualities, and
    VP8L with its own alpha: cv2's BGRA output with the alpha dropped."""
    for quality in (20, 80, 100):
        data = encode(encoder, tmp_path, _rgba(50, 70), 0, quality)
        assert [c[0] for c in chunks(data)] == [b"VP8X", b"ALPH", b"VP8 "]
        assert like_cv2(tmp_path, data)
    for exact in (0, 1):
        assert like_cv2(tmp_path, encode(encoder, tmp_path, _rgba(50, 70), 1,
                                         exact=exact))


def test_damaged_alpha(tmp_path, encoder):
    """An ALPH chunk that libwebp fails on fails the file: bit flips,
    cuts, each header byte; raw (uncompressed) alpha short or whole."""
    data = encode(encoder, tmp_path, _rgba(20, 30), 0, 50)
    _, alph, vp8 = chunks(data)
    rng = np.random.RandomState(0)
    read = []
    for _ in range(16):
        a = bytearray(alph[1])
        a[rng.randint(1, len(a))] ^= 1 << rng.randint(8)
        read.append(like_cv2(tmp_path, riff([vp8x(30, 20, 0x10),
                                             (b"ALPH", bytes(a)), vp8])))
    for cut in range(1, len(alph[1]), 3):
        read.append(like_cv2(tmp_path, riff([vp8x(30, 20, 0x10),
                                             (b"ALPH", alph[1][:cut]), vp8])))
    for head in (0x00, 0x01, 0x05, 0x09, 0x0D, 0x11, 0x21, 0x41, 0x02, 0x03):
        for rest in (alph[1][1:], bytes(600), bytes(599)):
            read.append(like_cv2(tmp_path, riff([
                vp8x(30, 20, 0x10), (b"ALPH", bytes([head]) + rest), vp8])))
    assert any(read) and not all(read)


@pytest.mark.parametrize("lossless", [0, 1])
def test_vp8x_chunks(tmp_path, encoder, lossless):
    img = content(20, 30, "noise")
    image = chunks(encode(encoder, tmp_path, img, lossless, 50))[0]
    for orientation in range(10):
        assert like_cv2(tmp_path, riff([vp8x(30, 20, 0x08), image,
                                        exif(orientation)]))
    files = {
        "no EXIF flag": riff([vp8x(30, 20, 0), image, exif(6)]),
        "two EXIF": riff([vp8x(30, 20, 0x08), exif(6), image, exif(1)]),
        "ICC": riff([vp8x(30, 20, 0x20), (b"ICCP", b"x" * 11), image]),
        "XMP": riff([vp8x(30, 20, 0x04), image, (b"XMP ", b"<x/>")]),
        "unknown": riff([vp8x(30, 20, 0), (b"ABCD", b"x" * 7), image]),
        "reserved flags": riff([vp8x(30, 20, 0xC1), image]),
        "simple + EXIF": riff([image, exif(6)]),
        "trailing bytes": riff([image]) + b"junk",
    }
    for name, data in files.items():
        assert like_cv2(tmp_path, data), name
    # libwebp decodes a VP8 image's ALPH chunk and ignores a VP8L one's
    assert like_cv2(tmp_path, riff([vp8x(30, 20, 0x10),
                                    (b"ALPH", bytes(10)), image])) == lossless
    refused = {
        "canvas": riff([vp8x(31, 20, 0), image]),
        "unknown first": riff([(b"ABCD", b"x" * 7), image]),
        "RIFF size large": riff([image])[:4] + struct.pack(
            "<I", len(riff([image]))) + riff([image])[8:],
        "RIFF size small": riff([image])[:4] + struct.pack(
            "<I", len(riff([image])) - 12) + riff([image])[8:],
    }
    for name, data in refused.items():
        assert not like_cv2(tmp_path, data), name


def test_animation(tmp_path, encoder):
    first = chunks(encode(encoder, tmp_path, content(20, 30, "noise"), 1))[0]
    second = chunks(encode(encoder, tmp_path, content(20, 30, "grey"), 0))[0]
    small = chunks(encode(encoder, tmp_path, content(10, 12, "noise", 2),
                          1))[0]
    alpha_ll = chunks(encode(encoder, tmp_path, _rgba(10, 12), 1, exact=1))[0]
    alpha_lossy = chunks(encode(encoder, tmp_path, _rgba(10, 12), 0, 50))[1:]
    read = {
        "two frames": riff([vp8x(30, 20, 0x02), ANIM,
                            anmf(0, 0, 30, 20, 0, first),
                            anmf(0, 0, 30, 20, 0, second)]),
        "offset": riff([vp8x(30, 20, 0x02), ANIM,
                        anmf(4, 2, 12, 10, 0, small)]),
        "alpha VP8L": riff([vp8x(30, 20, 0x12), ANIM,
                            anmf(4, 2, 12, 10, 0, alpha_ll)]),
        "alpha VP8": riff([vp8x(30, 20, 0x12), ANIM,
                           anmf(4, 2, 12, 10, 0, *alpha_lossy)]),
        "no blend": riff([vp8x(30, 20, 0x12), ANIM,
                          anmf(4, 2, 12, 10, 2, alpha_ll)]),
        "EXIF": riff([vp8x(30, 20, 0x0A), ANIM, anmf(4, 2, 12, 10, 0, small),
                      exif(6)]),
        "frame size from the image": riff([vp8x(30, 20, 0x02), ANIM,
                                           anmf(4, 2, 5, 5, 0, small)]),
    }
    for name, data in read.items():
        assert like_cv2(tmp_path, data), name
    refused = {
        "outside": riff([vp8x(30, 20, 0x02), ANIM,
                         anmf(20, 2, 12, 10, 0, small)]),
        "second outside": riff([vp8x(30, 20, 0x02), ANIM,
                                anmf(4, 2, 12, 10, 0, small),
                                anmf(25, 2, 12, 10, 0, small)]),
        "no ANIM": riff([vp8x(30, 20, 0x02), anmf(4, 2, 12, 10, 0, small)]),
        "no frame": riff([vp8x(30, 20, 0x02), ANIM]),
        "ALPH before VP8L": riff([vp8x(30, 20, 0x12), ANIM, anmf(
            4, 2, 12, 10, 0, (b"ALPH", bytes(200)), small)]),
        "bad ALPH": riff([vp8x(30, 20, 0x12), ANIM, anmf(
            4, 2, 12, 10, 0, (b"ALPH", b"\x01" + bytes(20)),
            alpha_lossy[1])]),
    }
    for name, data in refused.items():
        assert not like_cv2(tmp_path, data), name


@pytest.mark.parametrize("lossless", [0, 1])
def test_cut_and_flipped(tmp_path, encoder, lossless):
    """Cut inside the bitstream (the RIFF and chunk sizes rewritten to
    match, and not), and 24 single-bit flips: libwebp fails data that end
    before the last macroblock or pixel, and decodes flips as it can."""
    data = encode(encoder, tmp_path, mixed(), lossless, 60, partitions=2)
    tag, body = chunks(data)[0]
    read = [like_cv2(tmp_path, riff([(tag, body[:cut])]))
            for cut in np.linspace(10, len(body) - 1, 12).astype(int)]
    assert not any(read[:-1])
    for cut in np.linspace(10, len(body) - 1, 6).astype(int):
        assert not like_cv2(tmp_path, data[:cut + 20])
    rng = np.random.RandomState(lossless)
    for _ in range(24):
        flipped = bytearray(data)
        flipped[rng.randint(30, len(data))] ^= 1 << rng.randint(8)
        like_cv2(tmp_path, bytes(flipped))


def test_committed_fixtures_match_recipe():
    """The WebP files of ``data/testdata/formats/`` (``chip_smoke.py
    formats``' kinds ``webp_*``) are cv2.imwrite's output here: VP8 at
    quality 75 of the 500x375 fixture, VP8L of the progressive 160x120
    one, and that one with a left-to-right alpha ramp at quality 75 (VP8X,
    ALPH, VP8); a libwebp that encodes otherwise breaks this test, not the
    reader."""
    from objectdetectionpl_tpu_torch.tools import format_files
    from objectdetectionpl_tpu_torch.tools.fixture_trees import TESTDATA
    base = native.decode_one(str(TESTDATA / format_files.BASE))[..., ::-1]
    small = native.decode_one(str(TESTDATA / format_files.PROGRESSIVE))[
        ..., ::-1]
    ramp = (np.arange(160) * 255 // 159).astype(np.uint8)[None, :, None]
    quality = [cv2.IMWRITE_WEBP_QUALITY, 75]
    recipe = {"webp_lossy": (base, quality), "webp_lossless": (small, []),
              "webp_alpha": (np.concatenate(
                  [small, np.repeat(ramp, 120, 0)], -1), quality)}
    layouts = {"webp_lossy": [b"VP8 "], "webp_lossless": [b"VP8L"],
               "webp_alpha": [b"VP8X", b"ALPH", b"VP8 "]}
    for kind, (img, params) in recipe.items():
        ok, data = cv2.imencode(".webp", img, params)
        assert ok
        committed = format_files.COMMITTED[kind].read_bytes()
        assert data.tobytes() == committed, kind
        assert [c[0] for c in chunks(committed)] == layouts[kind]
