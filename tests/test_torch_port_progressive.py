"""The port's JPEG decoder (``csrc/jpeg_decode.cc``) on progressive and
multi-scan files and at libjpeg's reduced scales, and the fused
decode-and-resize call and the Loader on sources that scale, against
libjpeg-turbo and the JAX package.

- Progressive files bit-equal to cv2 (libjpeg-turbo): PIL-made over 4:4:4,
  4:2:2, 4:2:0 x quality 50, 75, 95 x sizes (odd ones among them) x
  Huffman optimisation; cv2-made with restart intervals 1 and 7 under
  4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1; grayscale.
- Scan scripts no writer's default gives, written by a small C helper
  compiled here against the system ``jpeglib.h`` (``jpeg_scan_info``):
  multi-scan sequential, DC first and then refinement scans, spectral
  bands without successive approximation, several refinement steps down
  to Al=0, each with and without restart intervals.  A script that leaves
  coefficient bits unsent decodes smoothed as libjpeg-turbo smooths it
  (cv2's and JAX's library's, each bit for bit); a broken progression
  raises ``JPEG_CORRUPT``.
- ``decode_one(path, denom)`` at 1/2, 1/4 and 1/8 bit-equal to
  ``cv2.IMREAD_REDUCED_COLOR_{2,4,8}`` (``IMREAD_REDUCED_GRAYSCALE_*`` for
  grayscale), baseline and progressive, all five samplings, sizes that are
  not multiples of 16, down to a scaled chroma 1 px wide; the committed
  1280x720 frames equal their recorded hashes at each scale.
- The fused ``decode_preproc_batch`` bit-equal to the JAX package's
  ``native.decode_preproc_batch`` (libjpeg with ``scale_denom``) at S=64
  on sources from 90 to 1100 px that make it pick denominators 1, 2, 4
  and 8: images, original sizes, scales, pads, letterbox off and on.
- The Loaders of both packages on a BDD100K tree of the 1280x720 frames and
  smaller fixtures: equal batches (images, labels, boxes, mask); the port's
  ``build_packed_cache`` on that tree equals JAX's, at full scale.
"""

import hashlib
import itertools
import re
import subprocess

import cv2
import numpy as np
import pytest
from PIL import Image

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.data import cache as jax_cache
from objectdetectionpl_tpu.data import datamodules as jax_dm
from objectdetectionpl_tpu.data import native as jax_native
from objectdetectionpl_tpu.data.parsers import BDD100KParser as JaxBDD
from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import cache, datamodules, native
from objectdetectionpl_tpu_torch.data.parsers import BDD100KParser
from objectdetectionpl_tpu_torch.tools import fixture_trees
from test_torch_port_cache import _assert_same_cache
from test_torch_port_data import (_assert_same_batches, _batches,  # noqa: F401
                                  jax_library)
from test_torch_port_jpeg import _cv2, _pil, smooth_image

SAMPLINGS = ("444", "422", "420", "440", "411")
COLOR = {1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
         4: cv2.IMREAD_REDUCED_COLOR_4, 8: cv2.IMREAD_REDUCED_COLOR_8}
GRAY = {1: cv2.IMREAD_GRAYSCALE, 2: cv2.IMREAD_REDUCED_GRAYSCALE_2,
        4: cv2.IMREAD_REDUCED_GRAYSCALE_4, 8: cv2.IMREAD_REDUCED_GRAYSCALE_8}


def _assert_libjpeg(path, denom: int = 1, gray: bool = False):
    """The port's decode at 1/denom equals cv2's, bit for bit."""
    path = str(path)
    ref = cv2.imread(path, (GRAY if gray else COLOR)[denom])
    ref = np.repeat(ref[..., None], 3, -1) if gray else ref[..., ::-1]
    got = native.decode_one(path, denom)
    assert got.dtype == np.uint8 and got.shape == ref.shape, (path, denom)
    if not np.array_equal(got, ref):
        d = np.abs(got.astype(int) - ref.astype(int))
        pytest.fail(f"{path} at 1/{denom}: max |diff| {d.max()} on "
                    f"{np.mean(d > 0):.2%} of samples")


def _sof(path) -> int:
    data = open(path, "rb").read()
    return next(m for m in (0xC0, 0xC1, 0xC2) if bytes([0xFF, m]) in data)


def _cv2_params(sampling, quality=85, progressive=0, interval=0):
    return [cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
            cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]


# --- progressive files at full scale ----------------------------------------


@pytest.mark.parametrize("subsampling,quality",
                         itertools.product((0, 1, 2), (50, 75, 95)))
def test_pil_progressive_bit_equal(tmp_path, subsampling, quality):
    rng = np.random.RandomState(200 + 3 * subsampling + quality)
    for (w, h), optimize in itertools.product(
            [(1, 1), (17, 9), (37, 53), (333, 251)], (False, True)):
        path = tmp_path / f"{w}x{h}_{int(optimize)}.jpg"
        _pil(path, smooth_image(h, w, rng, noise=12.0), quality=quality,
             subsampling=subsampling, optimize=optimize, progressive=True)
        assert _sof(path) == 0xC2
        _assert_libjpeg(path)


@pytest.mark.parametrize("interval", [1, 7])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_cv2_progressive_restart_bit_equal(tmp_path, interval, sampling):
    """Restart markers every 1 or 7 MCUs of each scan (an AC scan's MCU is
    one block): EOB runs and DC predictors restart with them."""
    rng = np.random.RandomState(interval * 10 + SAMPLINGS.index(sampling))
    for w, h in [(37, 53), (131, 77)]:
        path = tmp_path / f"{w}x{h}.jpg"
        _cv2(path, smooth_image(h, w, rng, noise=8.0),
             _cv2_params(sampling, progressive=1, interval=interval))
        assert _sof(path) == 0xC2
        _assert_libjpeg(path)


@pytest.mark.parametrize("interval", [0, 3])
def test_progressive_grayscale_bit_equal(tmp_path, interval):
    rng = np.random.RandomState(11 + interval)
    for w, h in [(1, 1), (37, 53), (64, 48)]:
        path = tmp_path / f"{w}x{h}.jpg"
        assert cv2.imwrite(str(path), smooth_image(h, w, rng, 1, 8.0)[..., 0],
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, interval])
        assert _sof(path) == 0xC2
        _assert_libjpeg(path, gray=True)


# --- scan scripts from libjpeg's own encoder --------------------------------

HELPER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

/* scans OUT W H NC QUALITY HSAMP VSAMP RESTART SCRIPT < W*H*NC bytes
   SCRIPT: scans separated by ';', each "ncomps c... Ss Se Ah Al" */
int main(int argc, char** argv) {
  if (argc != 10) return 2;
  int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]);
  unsigned char* px = malloc((size_t)w * h * nc);
  if (fread(px, 1, (size_t)w * h * nc, stdin) != (size_t)w * h * nc) return 3;
  static jpeg_scan_info scans[64];
  int n = 0;
  for (char* s = strtok(argv[9], ";"); s; s = strtok(NULL, ";"), ++n) {
    jpeg_scan_info* sc = &scans[n];
    int used, k;
    sscanf(s, "%d%n", &sc->comps_in_scan, &used);
    for (k = 0; k < sc->comps_in_scan; ++k) {
      int got;
      sscanf(s + used, "%d%n", &sc->component_index[k], &got);
      used += got;
    }
    sscanf(s + used, "%d %d %d %d", &sc->Ss, &sc->Se, &sc->Ah, &sc->Al);
  }
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* f = fopen(argv[1], "wb");
  jpeg_stdio_dest(&c, f);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, atoi(argv[5]), TRUE);
  c.comp_info[0].h_samp_factor = atoi(argv[6]);
  c.comp_info[0].v_samp_factor = atoi(argv[7]);
  c.restart_interval = atoi(argv[8]);
  c.scan_info = scans;
  c.num_scans = n;
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

# name -> the scan script of a 3-component image (Y, Cb, Cr = 0, 1, 2)
SCRIPTS = {
    "multi_scan_sequential": "1 0 0 63 0 0; 1 1 0 63 0 0; 1 2 0 63 0 0",
    "sequential_y_then_chroma": "1 0 0 63 0 0; 2 1 2 0 63 0 0",
    "dc_refinement_first": (
        "3 0 1 2 0 0 0 3; 3 0 1 2 0 0 3 2; 3 0 1 2 0 0 2 1; "
        "3 0 1 2 0 0 1 0; 1 0 1 63 0 0; 1 1 1 63 0 0; 1 2 1 63 0 0"),
    "spectral_bands": (
        "1 0 0 0 0 0; 2 1 2 0 0 0 0; 1 0 1 5 0 0; 1 0 6 20 0 0; "
        "1 0 21 63 0 0; 1 2 1 63 0 0; 1 1 1 63 0 0"),
    "refinement_steps": (
        "3 0 1 2 0 0 0 1; 1 0 1 9 0 3; 1 0 10 63 0 2; 1 1 1 63 0 2; "
        "1 2 1 63 0 2; 1 0 1 9 3 2; 1 0 1 9 2 1; 1 0 10 63 2 1; "
        "1 0 1 63 1 0; 1 1 1 63 2 1; 1 1 1 63 1 0; 1 2 1 63 2 1; "
        "1 2 1 63 1 0; 3 0 1 2 0 0 1 0"),
}
INCOMPLETE = {
    # the luma's AC keeps its lowest bit: 2..1 sent, 1..0 not
    "ac_bits_unsent": ("3 0 1 2 0 0 0 0; 1 0 1 63 0 1; 1 1 1 63 0 0; "
                       "1 2 1 63 0 0", "coefficient 1 of component 1 "
                                       "lacks its 1 low bits"),
    # no AC scan of the chroma at all
    "ac_never_sent": ("3 0 1 2 0 0 0 0; 1 0 1 63 0 0",
                      "coefficient 1 of component 2 is never sent"),
}


@pytest.fixture(scope="module")
def scans_tool(tmp_path_factory):
    d = tmp_path_factory.mktemp("scans")
    (d / "scans.c").write_text(HELPER)
    subprocess.run(["cc", "-O1", str(d / "scans.c"), "-ljpeg", "-o",
                    str(d / "scans")], check=True, capture_output=True)
    return str(d / "scans")


def _write_script(tool, path, img, script, hv=(2, 2), quality=80,
                  restart=0):
    h, w, nc = img.shape
    subprocess.run([tool, str(path), str(w), str(h), str(nc), str(quality),
                    str(hv[0]), str(hv[1]), str(restart), script],
                   input=np.ascontiguousarray(img).tobytes(), check=True,
                   capture_output=True)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scan_script_bit_equal(tmp_path, scans_tool, name):
    rng = np.random.RandomState(len(name))
    for (w, h), hv, restart in [((45, 37), (2, 2), 0), ((64, 48), (1, 1), 0),
                                ((45, 37), (2, 1), 3), ((131, 77), (2, 2), 5)]:
        path = tmp_path / f"{w}x{h}_{hv[0]}{hv[1]}_{restart}.jpg"
        _write_script(scans_tool, path, smooth_image(h, w, rng, noise=10.0),
                      SCRIPTS[name], hv=hv, restart=restart)
        assert (_sof(path) == 0xC2) == ("sequential" not in name)
        assert open(path, "rb").read().count(b"\xff\xda") == \
            SCRIPTS[name].count(";") + 1
        for denom in (1, 4):
            _assert_libjpeg(path, denom)


@pytest.mark.parametrize("name", list(INCOMPLETE))
def test_incomplete_script_raises(tmp_path, scans_tool, jax_library, name):
    """A script that leaves coefficient bits unsent, which the decoder
    refused until it smoothed the blocks as libjpeg-turbo's jdcoefct.c
    does: bit-equal to cv2 (libjpeg-turbo 3) on the cv2 route and to JAX's
    library (the system libjpeg-turbo 2.1, whose neighbour rows differ) on
    the fused route, at every denominator."""
    script, _ = INCOMPLETE[name]
    path = str(tmp_path / "incomplete.jpg")
    _write_script(scans_tool, path,
                  smooth_image(37, 45, np.random.RandomState(0)), script)
    np.testing.assert_array_equal(native.decode_one(path, imread=True),
                                  load_image_rgb(path))
    for target in (37, 18, 9, 4):              # denominators 1, 2, 4, 8
        want = jax_native.decode_preproc_batch([path], target, False)
        got = native.decode_preproc_batch([path], target, False,
                                          max_denom=native.MAX_DENOM)
        assert want[-1][0]
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("patch,reason", [
    ("dc_scan_with_se", "bad progressive scan parameters Ss=0 Se=5"),
    ("refine_skips_a_bit", None)])
def test_bad_progression_raises(tmp_path, scans_tool, jax_library, patch,
                                reason):
    """libjpeg's start_pass_phuff_decoder: Ss=0 only with Se=0 is an error
    (cv2, the JAX library and the port refuse the file); a refinement whose
    Ah is not the previous scan's Al is only JWRN_BOGUS_PROGRESSION, and
    the scan decodes with its own Ah and Al: the port reads the file as
    cv2 does on the imread route and as the JAX library does on the fused
    route, bit for bit."""
    path = tmp_path / "src.jpg"
    _write_script(scans_tool, path,
                  smooth_image(37, 45, np.random.RandomState(1)),
                  SCRIPTS["dc_refinement_first"])
    data = bytearray(path.read_bytes())
    sos = [m.start() for m in re.finditer(b"\xff\xda", bytes(data))]
    if patch == "dc_scan_with_se":        # the first scan: Se 0 -> 5
        ns = data[sos[0] + 4]
        data[sos[0] + 5 + 2 * ns + 1] = 5
    else:                                 # the DC refinement 3/2 -> 2/1
        ns = data[sos[1] + 4]
        data[sos[1] + 5 + 2 * ns + 2] = 0x21
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(bytes(data))
    if reason:
        with pytest.raises(native.JpegError,
                           match=f"^{re.escape(str(bad))}: {reason}"):
            native.decode_one(str(bad))
        with pytest.raises(OSError):
            load_image_rgb(str(bad))
        assert not jax_native.decode_preproc_batch([str(bad)], 37,
                                                   False)[-1][0]
        return
    want = load_image_rgb(str(bad))
    np.testing.assert_array_equal(native.decode_one(str(bad), imread=True),
                                  want)
    clean = native.decode_one(str(path), imread=True)
    assert not np.array_equal(want, clean)        # the patch changed pixels
    for target in (37, 18, 9, 4):              # denominators 1, 2, 4, 8
        ref = jax_native.decode_preproc_batch([str(bad)], target, False)
        got = native.decode_preproc_batch([str(bad)], target, False,
                                          max_denom=native.MAX_DENOM)
        assert ref[-1][0]
        np.testing.assert_array_equal(got[0], ref[0])


# --- reduced scales ---------------------------------------------------------


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("denom", [2, 4, 8])
def test_reduced_scale_bit_equal(tmp_path, denom, progressive):
    """Every sampling at sizes that are not multiples of 16, among them
    ones whose scaled chroma is 1 or 2 samples wide (box, not fancy,
    upsampling) and ones that scale to 1x1."""
    rng = np.random.RandomState(denom * 2 + progressive)
    for sampling, (w, h) in itertools.product(
            SAMPLINGS, [(9, 7), (37, 53), (131, 77)]):
        path = tmp_path / f"{sampling}_{w}x{h}.jpg"
        _cv2(path, smooth_image(h, w, rng, noise=8.0),
             _cv2_params(sampling, progressive=progressive,
                         interval=3 if w == 37 else 0))
        _assert_libjpeg(path, denom)


@pytest.mark.parametrize("progressive", [0, 1])
def test_reduced_scale_grayscale_bit_equal(tmp_path, progressive):
    rng = np.random.RandomState(30 + progressive)
    for w, h in [(5, 3), (37, 53), (200, 150)]:
        path = tmp_path / f"{w}x{h}.jpg"
        assert cv2.imwrite(str(path), smooth_image(h, w, rng, 1, 8.0)[..., 0],
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
        for denom in (2, 4, 8):
            _assert_libjpeg(path, denom, gray=True)


@pytest.mark.parametrize("name", fixture_trees.BDD_FRAMES)
def test_frames_equal_their_hashes_at_each_scale(name):
    want = fixture_trees.fixtures()[name]
    path = str(fixture_trees.TESTDATA / name)
    assert sorted(want["scaled"]) == ["2", "4", "8"]
    for denom, entry in [("1", want), *want["scaled"].items()]:
        got = native.decode_one(path, int(denom))
        assert list(got.shape) == entry["shape"]
        assert got.shape[:2] == (-(-720 // int(denom)), -(-1280 // int(denom)))
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def test_denominator_is_checked():
    path = str(fixture_trees.TESTDATA / fixture_trees.BDD_FRAMES[0])
    for bad in (0, 3, 16):
        with pytest.raises(ValueError, match="denom must be one of"):
            native.decode_one(path, bad)
        with pytest.raises(ValueError, match="denom must be one of"):
            native.decode_preproc_batch([path], 64, False, max_denom=bad)


# --- the fused call and the Loader against the JAX package ------------------

S = 64
# (w, h) -> the denominator JAX's rule picks at S=64
SOURCES = {(100, 90): 1, (260, 200): 2, (333, 251): 2, (600, 400): 4,
           (1100, 1040): 8}


def _jax_denom(w, h, target, max_denom=8):
    d = 1
    while d < max_denom and w // (2 * d) >= target and h // (2 * d) >= target:
        d *= 2
    return d


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("sources")
    rng = np.random.RandomState(7)
    paths = []
    for k, (w, h) in enumerate(SOURCES):
        path = d / f"src{k}_{w}x{h}.jpg"
        _cv2(path, smooth_image(h, w, rng, noise=4.0),
             _cv2_params(SAMPLINGS[k % 5], quality=80, progressive=k % 2,
                         interval=k))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("letterbox", [False, True])
def test_fused_batch_equals_jax(sources, jax_library, letterbox):
    assert {_jax_denom(w, h, S) for w, h in SOURCES} == {1, 2, 4, 8}
    assert all(_jax_denom(w, h, S) == d for (w, h), d in SOURCES.items())
    got = native.decode_preproc_batch(sources, S, letterbox,
                                      max_denom=native.MAX_DENOM)
    want = jax_native.decode_preproc_batch(sources, S, letterbox)
    assert want[-1].all()                       # JAX decoded every file
    names = ["images", "orig_ws", "orig_hs", "scales", "pad_xs", "pad_ys"]
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[1], [w for w, _ in SOURCES])
    # full scale is another batch: the scale was taken
    full = native.decode_preproc_batch(sources, S, letterbox)
    assert not np.array_equal(full[0][1:], got[0][1:])
    np.testing.assert_array_equal(full[0][0], got[0][0])


def test_fused_batch_resizes_the_scaled_decode(sources):
    """The float32 path is ``decode_one(path, d)`` then ``preproc_batch``,
    bit for bit, with the letterbox scale mapped to the original."""
    got, ows, _, scales, _, _ = native.decode_preproc_batch(
        sources, S, True, max_denom=native.MAX_DENOM)
    images = [native.decode_one(p, d) for p, d in zip(sources,
                                                      SOURCES.values())]
    want, wscales, _, _ = native.preproc_batch(images, S, True)
    np.testing.assert_array_equal(got, want)
    ratio = (np.asarray([im.shape[1] for im in images], np.float32)
             / ows.astype(np.float32))
    np.testing.assert_array_equal(scales, wscales * ratio)


@pytest.fixture(scope="module")
def bdd_root(tmp_path_factory):
    names = list(fixture_trees.BDD_FRAMES) + [
        "coco_420_q75_640x480.jpg", "voc_420_q75_500x375.jpg",
        "progressive_420_q75_160x120.jpg"]
    return fixture_trees.write_bdd100k_tree(tmp_path_factory.mktemp("bdd"),
                                            n_train=10, n_val=5, seed=8,
                                            names=names)


@pytest.mark.parametrize("letterbox", [False, True])
def test_bdd_loader_batches_equal_jax(bdd_root, jax_library, letterbox):
    """At 128 px JAX decodes the frames at 1/4, the 640x480 and 500x375
    fixtures at 1/2 and the 160x120 one at full scale."""
    assert [_jax_denom(w, h, 128) for w, h in
            [(1280, 720), (640, 480), (500, 375), (160, 120)]] == [4, 2, 2, 1]
    kw = dict(data_module="BDD100K", data_root=bdd_root, batch_size=3,
              img_size=128, max_boxes=4, letterbox=letterbox, seed=2,
              stage="all")
    port = datamodules.build_datamodule(Config(**kw))
    ref = jax_dm.build_datamodule(JaxConfig(**kw))
    assert jax_native.available()
    for split in ("train", "val", "test"):
        pl, rl = (getattr(m, f"{split}_dataloader")() for m in (port, ref))
        assert pl.decode_path == "fused"
        assert len(pl) == len(rl) > 0
        _assert_same_batches(_batches(pl), _batches(rl))


def test_bdd_cache_equals_jax_at_full_scale(bdd_root, tmp_path):
    """The uint8 cache decodes at full scale (``max_denom=1``), as JAX's
    cache build reads its images with cv2.imread."""
    port, ref = (BDD100KParser(bdd_root, "val"), JaxBDD(bdd_root, "val"))
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    cache.build_packed_cache(port, 64, got, False)
    jax_cache.build_packed_cache(ref, 64, want, letterbox=False)
    _assert_same_cache(got, want)
    # a frame, which the float32 path decodes at 1/4 at 64 px
    assert load_image_rgb(port.record(0)[0]).shape == (720, 1280, 3)
