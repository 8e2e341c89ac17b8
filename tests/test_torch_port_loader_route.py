"""The Loader's route for each batch and the packed cache on trees that
hold the files a scraped tree holds, against the JAX package.

The JAX Loader takes its fused libjpeg call (an RGB request at the DCT
scale, EXIF ignored) only for a batch whose records all end in .jpg /
.jpeg and that the call decodes whole; any other batch is read by its
parser with ``cv2.imread`` at full scale, EXIF-turned, then resized.  The
trees here (VOC and COCO, from ``tools/fixture_trees.py``, at 64 px, where
the 500x375 and larger fixtures decode at 1/4 or 1/8 on the fused route)
have some images replaced by: the committed CMYK fixture (which the fused
call refuses), a file cut at half its bytes and a bit-flipped one (which
it decodes), a PNG named ``.jpg``, a 500x375 copy with EXIF Orientation
6, a lossless JPEG (which JAX's libjpeg 2.1 refuses on the fused route and
cv2 reads), a VP8 and a VP8L WebP, an LZW TIFF, one file of each
format the port reads since (cv2's writes of a JP2, a GIF, a PPM, a PAM,
a PFM, a Sun raster and a Radiance HDR, and a committed J2K codestream),
and one TIFF of each kind of ``format_files.tiff_kinds`` and the
committed JPEG, fax and SGILog TIFFs (JPEG compression in a strip,
strips and tiles, YCbCr, CMYK, CIELab, CCITT RLE, Group 3 and Group 4,
FillOrder 2, old-style LZW, ThunderScan, signed samples, LogLuv and
LogL), and two AVIFs (cv2's write and the committed Pillow one), named
``.jpg`` in the VOC tree and the VP8, TIFF, JP2, J2K, GIF, PAM, Sun
raster and cv2's AVIF files and half of the newer TIFFs by their own
extension in the COCO tree.

- The port's batches equal JAX's bit for bit, epoch after epoch; the port
  counts its fused and parser batches, and every batch holding the CMYK
  file, the PNG, the lossless JPEG, a WebP, the TIFF or a file of the
  newer formats took the parser route.
- A batch that took the parser route equals ``preproc_batch`` of
  ``decode_image`` (full scale, turned) and differs from the fused call's
  decode of the same files.
- ``build_packed_cache`` on the same trees equals JAX's byte for byte.
"""

import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.data import cache as jax_cache
from objectdetectionpl_tpu.data import datamodules as jax_dm
from objectdetectionpl_tpu.data.parsers import COCOParser as JaxCOCO
from objectdetectionpl_tpu.data.parsers import VOCParser as JaxVOC
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import cache, datamodules, native
from objectdetectionpl_tpu_torch.data.parsers import COCOParser, VOCParser
from objectdetectionpl_tpu_torch.tools import fixture_trees, format_files
from objectdetectionpl_tpu_torch.tools.format_files import (
    lossless_jpeg_bytes, tiff_bytes)
from test_torch_port_cache import _assert_same_cache
from test_torch_port_data import (_assert_same_batches, _batches,  # noqa: F401
                                  jax_library)
from test_torch_port_exif import app1, spliced, tiff

S = 64
VOC_FIXTURE = "voc_420_q75_500x375.jpg"


def _replacements():
    """{slot: bytes} of the odd files, slot i of the tree's sorted images."""
    voc = (fixture_trees.TESTDATA / VOC_FIXTURE).read_bytes()
    small = native.decode_one(str(fixture_trees.TESTDATA / VOC_FIXTURE))[
        ::4, ::4]
    flipped = bytearray((fixture_trees.TESTDATA /
                         "restart7_420_q90_333x251.jpg").read_bytes())
    flipped[len(flipped) // 2] ^= 0x10
    assert 0xFF not in flipped[len(flipped) // 2 - 1:len(flipped) // 2 + 1]
    ok, png = cv2.imencode(".png", cv2.imread(
        str(fixture_trees.TESTDATA / "coco_420_q75_640x480.jpg")))
    assert ok
    bgr = np.ascontiguousarray(small[..., ::-1])
    written = {}
    for slot, ext, img in ((16, ".jp2", bgr), (18, ".gif", bgr),
                           (19, ".ppm", bgr), (20, ".pam", bgr),
                           (21, ".pfm", bgr.astype(np.float32)),
                           (22, ".ras", bgr),
                           (23, ".hdr", bgr.astype(np.float32) / 255),
                           (41, ".avif", bgr)):
        ok, data = cv2.imencode(ext, img)
        assert ok
        written[slot] = data.tobytes()
    return {**written,
        17: format_files.COMMITTED["j2k_rpcl_precincts"].read_bytes(),
        1: (fixture_trees.TESTDATA / fixture_trees.UNSUPPORTED[0])
        .read_bytes(),                                       # CMYK
        4: voc[:len(voc) // 2],                              # cut
        6: bytes(flipped),                                   # damaged
        9: png.tobytes(),                                    # PNG as .jpg
        13: spliced(VOC_FIXTURE, app1(tiff("II", [(0x0112, 3, 1, 6)]))),
        3: lossless_jpeg_bytes(small, psv=4, restart_rows=5),
        7: format_files.COMMITTED["webp_lossy"].read_bytes(),
        11: format_files.COMMITTED["webp_lossless"].read_bytes(),
        14: tiff_bytes(small, compression=5, predictor=2, rows_per_strip=8),
        **{24 + i: data for i, data in enumerate(_tiff_kinds(voc, small))},
        42: format_files.COMMITTED["avif_pillow"].read_bytes(),
    }


def _tiff_kinds(voc: bytes, small: np.ndarray):
    """The TIFFs of JPEG compression, YCbCr, CMYK, CIELab, CCITT fax,
    FillOrder 2, old-style LZW, ThunderScan and signed samples, as
    ``format_files`` makes them."""
    made = format_files.tiff_kinds(voc, small)
    committed = {k: format_files.COMMITTED[k].read_bytes()
                 for k in TIFF_COMMITTED}
    return [{**made, **committed}[k] for k in TIFF_KINDS]


TIFF_COMMITTED = ("tiff_jpeg_strips", "tiff_jpeg_tiles", "tiff_g3_2d",
                  "tiff_g4", "tiff_ccitt_rle", "tiff_logluv", "tiff_logl")
TIFF_KINDS = ("tiff_jpeg_ycbcr", "tiff_jpeg_cmyk", "tiff_ycbcr",
              "tiff_ycbcr_44_tiles", "tiff_cmyk", "tiff_cielab",
              "tiff_fillorder2", "tiff_lzw_old", "tiff_thunderscan",
              "tiff_signed") + TIFF_COMMITTED


# the slots whose file keeps its own extension in the COCO tree (the VOC
# tree names every file .jpg)
OWN_NAME = {7: ".webp", 14: ".tiff", 16: ".jp2", 17: ".j2k", 18: ".gif",
            20: ".pam", 22: ".ras", 41: ".avif",
            **{24 + i: ".tif" for i in range(0, len(TIFF_KINDS), 2)}}


def _replace(paths, rename=False):
    """Write the odd files over the tree's slots; with ``rename`` the
    ``OWN_NAME`` slots move to their format's extension.  Returns {old
    name: new name}."""
    renamed = {}
    for slot, data in _replacements().items():
        paths[slot].unlink()                   # a link to a fixture
        path = paths[slot]
        if rename and slot in OWN_NAME:
            path = path.with_suffix(OWN_NAME[slot])
            renamed[paths[slot].name] = path.name
        path.write_bytes(data)
    return renamed


@pytest.fixture(scope="module")
def mixed_voc(tmp_path_factory):
    root = fixture_trees.write_voc_tree(tmp_path_factory.mktemp("voc"),
                                        n_train=80, n_val=4, seed=3)
    _replace(sorted((Path(root) / "VOC2012" / "JPEGImages").iterdir()))
    return root


@pytest.fixture(scope="module")
def mixed_coco(tmp_path_factory):
    root = fixture_trees.write_coco_tree(tmp_path_factory.mktemp("coco"),
                                         n_train=80, n_val=4, seed=4)
    ann_path = Path(root) / "annotations" / "instances_train2017.json"
    ann = json.loads(ann_path.read_text())
    image_dir = Path(root) / "images" / "train2017"
    renamed = _replace([image_dir / im["file_name"] for im in ann["images"]],
                       rename=True)
    for im in ann["images"]:
        im["file_name"] = renamed.get(im["file_name"], im["file_name"])
    ann_path.write_text(json.dumps(ann))
    return root


def _loaders(data_module, root, letterbox):
    kw = dict(data_module=data_module, data_root=root, batch_size=4,
              img_size=S, letterbox=letterbox, stage="fit")
    return (datamodules.build_datamodule(Config(**kw)).train_dataloader(),
            jax_dm.build_datamodule(JaxConfig(**kw)).train_dataloader())


@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("data_module", ["VOC", "COCO"])
def test_batches_and_routes_equal_jax(mixed_voc, mixed_coco, jax_library,
                                      data_module, letterbox):
    root = mixed_voc if data_module == "VOC" else mixed_coco
    port, ref = _loaders(data_module, root, letterbox)
    assert port.decode_path == "fused"
    _assert_same_batches(_batches(port, epochs=2), _batches(ref, epochs=2))
    odd = {port.parser.record(i)[0] for i in range(len(port.parser))
           if native.decode_preproc_codes([port.parser.record(i)[0]], S,
                                          False, max_denom=8)[-1][0]}
    # the CMYK file, the PNG, the lossless JPEG, both WebPs, the TIFFs, the
    # JP2, the J2K codestream, the GIF, the PPM, the PAM, the PFM, the Sun
    # raster, the Radiance HDR and both AVIFs
    assert len(odd) == 16 + len(TIFF_KINDS)
    # batches holding one of them take the parser route, the others fused
    n_odd = 0
    for epoch in range(2):
        order = port.indices.copy()
        np.random.RandomState(port.seed + epoch).shuffle(order)
        for b in range(len(port)):
            recs = [port.parser.record(int(i))[0]
                    for i in order[b * 4:(b + 1) * 4]]
            n_odd += bool(odd & set(recs))
    assert port.parser_batches == n_odd > 0
    assert port.fused_batches == 2 * len(port) - n_odd > 0


def test_parser_route_is_full_scale_and_turned(mixed_voc, jax_library):
    """The batch-mates of the CMYK file are read at full scale and turned,
    not at the fused call's DCT scale."""
    parser = VOCParser(mixed_voc, "2012", "train")
    paths = [parser.record(i)[0] for i in range(len(parser))]
    cmyk, turned = paths[1], paths[13]
    mates = [cmyk, turned, paths[0], paths[2]]
    loader = datamodules.build_datamodule(Config(
        data_module="VOC", data_root=mixed_voc, batch_size=4, img_size=S,
        stage="fit")).train_dataloader()
    loader.indices = np.asarray([1, 13, 0, 2])
    loader.shuffle = False
    (batch,) = _batches(loader)
    assert (loader.fused_batches, loader.parser_batches) == (0, 1)
    images = [native.decode_image(p) for p in mates]
    assert images[1].shape == (500, 375, 3)              # turned
    want = native.preproc_batch(images, S, False)[0]
    np.testing.assert_array_equal(batch.images, want)
    fused = native.decode_preproc_codes(mates[1:], S, False,
                                        max_denom=native.MAX_DENOM)
    assert not fused[-1].any()
    assert not np.array_equal(fused[0][0], want[1])      # 1/4, unturned


@pytest.mark.parametrize("data_module", ["VOC", "COCO"])
def test_packed_cache_equals_jax(tmp_path, mixed_voc, mixed_coco,
                                 data_module):
    if data_module == "VOC":
        port = VOCParser(mixed_voc, "2012", "train")
        ref = JaxVOC(mixed_voc, "2012", "train")
    else:
        port = COCOParser(mixed_coco, "2017", "train")
        ref = JaxCOCO(mixed_coco, "2017", "train")
    got = cache.build_packed_cache(port, S, str(tmp_path / "port"))
    want = jax_cache.build_packed_cache(ref, S, str(tmp_path / "jax"))
    _assert_same_cache(got, want)
    shutil.rmtree(tmp_path / "port")
