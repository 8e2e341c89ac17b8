"""Damaged JPEG headers (ROADMAP §C 1), read as libjpeg reads them.

The cases are ``tools/format_files.py::header_cases``: the committed
fixtures patched byte by byte.  Two references, as in the JAX package:

- the imread route (``native.decode_image``, the parsers' route,
  ``cli.predict``) against ``load_image_rgb`` (``cv2.imread``,
  libjpeg-turbo 3): equal pixels, or both refuse;
- the fused route (``native.decode_preproc_codes``) against the JAX
  library's ``decode_preproc_batch`` (the system libjpeg 2.1, which fails a
  file whose ``jpeg_finish_decompress`` raises) at the denominators 1, 2,
  4 and 8: equal images, or both refuse.

Which rule reads or refuses each case:

- a sequential Huffman file whose scan names an empty DC or AC slot 0 or
  1 takes the tables of T.81 K.3 (jdhuff.c's ``std_huff_tables``, on both
  routes); an empty slot 2 or 3, and any empty slot of a progressive file,
  is refused; arithmetic scans take conditioning tables 0..15;
- bytes before a marker, a stuffed 0xFF00 among them, are skipped
  (``next_marker``); ``01 FF 02`` before the SOS makes a marker 0x02, which
  both refuse;
- an unknown marker in the header is refused; after the scan of a file of
  one scan -- at its end, in its data, where a restart marker was due --
  cv2 has read every scanline and swallows what ``jpeg_finish_decompress``
  raises, so the imread route reads it and the fused route refuses it; in
  a progressive file it is refused;
- a second SOF after that scan: the same; in a progressive file, refused;
- a bad progression that libjpeg only warns about (JWRN_BOGUS_PROGRESSION)
  decodes with the scan's own Ah and Al.

The committed hashes (``formats/headers_sha256.json``) hold cv2's decode of
each case, or null, and the JAX library's fused outcome; ``chip_smoke.py``
checks the port against them on the card's host.  Then the Loader's
parser route on a VOC tree of the cases cv2 reads, against JAX's Loader,
and ``cli.predict``'s input on each.
"""

import hashlib
import json
import struct

import numpy as np
import pytest

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.data import datamodules as jax_dm
from objectdetectionpl_tpu.data.parsers.common import (
    load_image_rgb as jax_load_image_rgb)
from objectdetectionpl_tpu.data.pipeline import _resize
from objectdetectionpl_tpu_torch.cli import predict
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import datamodules, native
from objectdetectionpl_tpu_torch.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.tools import fixture_trees, format_files
from objectdetectionpl_tpu_torch.tools.fixture_trees import TESTDATA
from test_torch_port_data import (_assert_same_batches, _batches,  # noqa: F401
                                  jax_library)
from test_torch_port_jpeg_damaged import _cv2_route, _fused_route

CASES = format_files.header_cases()
RECORD = json.loads(format_files.HEADER_HASHES.read_text())
READ = [c for c in CASES if RECORD[c]["sha256"]]

# the port's reason for each case it refuses on the imread route, and for
# each case whose fused route it refuses while cv2 reads it
REFUSED = {
    "sos_names_dc_slot_2": "Huffman table not defined before the scan",
    "no_dht_progressive": "Huffman table not defined before the scan",
    "junk_01ff02_before_sos": "unexpected marker 0xFF02",
    "marker_9e_in_header": "unexpected marker 0xFF9E",
    "marker_f3_in_header": "unexpected marker 0xFFF3",
    "marker_9e_progressive": "unexpected marker 0xFF9E",
    "sof_progressive": "a second SOF marker",
}
FUSED_REFUSED = {
    "marker_9e_at_scan_end": "unexpected marker 0xFF9E",
    "marker_f3_at_scan_end": "unexpected marker 0xFFF3",
    "marker_9e_mid_scan": "unexpected marker 0xFF9E",
    "marker_f3_for_rst": "unexpected marker 0xFFF3",
    "sof_for_rst": "a second SOF marker",
    "sof_at_scan_end": "a second SOF marker",
}


def _sof_size(data: bytes):
    """(w, h) from the first frame header (SOF0-2, SOF9-10)."""
    i = next(i for i in range(len(data) - 1) if data[i] == 0xFF
             and data[i + 1] in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA))
    h, w = struct.unpack(">HH", data[i + 5:i + 9])
    return w, h


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return format_files.write_header_cases(tmp_path_factory.mktemp("hdr"))


def test_recipe_and_record_agree(cases, jax_library):
    """Every case, as the recipe writes it, has cv2's recorded decode (or
    cv2's refusal) and the JAX library's recorded fused outcome."""
    from objectdetectionpl_tpu.data import native as jax_native
    assert sorted(cases) == sorted(RECORD)
    for case, path in cases.items():
        try:
            img = jax_load_image_rgb(path)
        except OSError:
            img = None
        want = RECORD[case]
        if img is None:
            assert want["sha256"] is None, case
        else:
            assert list(img.shape) == want["shape"], case
            assert hashlib.sha256(img.tobytes()).hexdigest() == \
                want["sha256"], case
        fused = jax_native.decode_preproc_batch([path], 64, False)[-1][0]
        assert bool(fused) == want["fused"], case


@pytest.mark.parametrize("case", list(CASES))
def test_both_routes_as_libjpeg(cases, jax_library, case):
    path = cases[case]
    read = _cv2_route(path)
    assert read == (case not in REFUSED), case
    fused = _fused_route(path, _sof_size(CASES[case]))
    assert fused == RECORD[case]["fused"], case
    if case in REFUSED:
        with pytest.raises(native.ImageError, match=REFUSED[case]):
            native.decode_image(path)
    if case in FUSED_REFUSED:
        code = native.decode_preproc_codes([path], 64, False)[-1]
        assert code[0] != native.JPEG_OK
        with pytest.raises(native.JpegError, match=FUSED_REFUSED[case]):
            native.decode_one(path)
    assert read or not fused, case          # the fused route reads less


def test_standard_tables_are_t81_k3(cases):
    """The 640x480 fixture was written with the K.3 tables: without its
    DHT segments it decodes to the same pixels, on both routes; the
    optimized fixture's own tables differ, so without them its pixels
    change."""
    for case, fixture, same in (("no_dht", format_files.COCO, True),
                                ("no_dht_optimized",
                                 "optimized_420_q80_320x240.jpg", False)):
        intact = str(TESTDATA / fixture)
        for decode in (native.decode_image, native.decode_one):
            assert np.array_equal(decode(cases[case]),
                                  decode(intact)) == same, case


def test_predict_input_equals_jax(cases):
    """``cli.predict``'s input of each case cv2 reads: the port's
    ``load_image_rgb`` and resize, bit for bit the JAX CLI's."""
    for case in READ:
        path = cases[case]
        want = _resize(jax_load_image_rgb(path), 96).astype(
            np.float32)[None] / 255.0
        np.testing.assert_array_equal(
            predict.resize_input(load_image_rgb(path), 96), want,
            err_msg=case)


def test_loader_parser_route_equals_jax(tmp_path, cases, jax_library):
    """A VOC tree of the cases cv2 reads (each a train id, named .jpg):
    the port's Loader equals JAX's batch for batch, the files the fused
    route refuses taking their batches to the parser route in both."""
    root = fixture_trees.write_voc_tree(
        tmp_path, n_train=len(READ), n_val=2, seed=5,
        files=[cases[c] for c in READ])
    kw = dict(data_module="VOC", data_root=root, batch_size=4, img_size=64,
              stage="fit")
    port = datamodules.build_datamodule(Config(**kw)).train_dataloader()
    ref = jax_dm.build_datamodule(JaxConfig(**kw)).train_dataloader()
    _assert_same_batches(_batches(port), _batches(ref))
    assert port.parser_batches > 0 and port.fused_batches >= 0
