"""The port's predict CLI (``cli/predict.py``) and PNG writer
(``utils/viz.py::write_png``) against the JAX package.

- ``predict_images`` against JAX's chain on bridged weights: YOLOv5s at
  64 px, 3 classes, the baseline fixture JPEGs (``PATHS``).  The JAX side is
  the JAX CLI's own: ``load_image_rgb`` (cv2) -> ``_resize`` (cv2's uint8
  INTER_LINEAR) / 255 -> the JAX Trainer's ``predict_step`` -> the JAX
  CLI's JSON fields.
  ``image`` and ``labels`` are equal; ``boxes_xyxy`` and ``scores``, which
  the CLI rounds to 2 and 4 decimals, are within one unit of that rounding
  plus the tolerance of the unrounded values.  The weights follow
  ``test_torch_port_trainer.py``: BN scales and biases drawn at random, the
  BN running statistics the inputs' own moments plus 0.03, zero head
  biases, and ``conf_thres`` 0.75 with no candidate within 1e-3 of it and
  scores 3e-4 of their value apart (asserted), so that both frameworks keep
  the same rows; drawn from each seed from 13 to 55 at which those margins
  hold on these inputs (``SEEDS``: 39, 44, 55).  Each image is held twice:
  - the port's decode and NMS against JAX's ``postprocess`` on the port's
    own head maps: the same rows and labels, boxes and scores within
    ``CHAIN_TOL`` (rtol 1e-6, atol 1e-4; measured at most 1.5e-5);
  - end to end, against JAX's forward: scores within rtol 1e-4, atol 1e-6
    (as obj in ``test_torch_port_trainer.py``), boxes within rtol 1e-4 and
    an atol of 1e-3 or, where larger, the largest difference between the
    candidate boxes that XLA's and torch's f32 forwards decode to (rows
    above conf_thres): a merged box is an obj-weighted mean of its
    candidates, whose weights differ by about 2e-5.  Measured at these
    seeds with 1, 2 and 8 torch threads: that forward noise up to 3.9e-3
    px an image, the merged boxes up to 2.4e-3 px apart (at most 0.88 of
    this tolerance, 1.09 of the fixed one), and with JAX's NMS on the
    port's head maps at most 1.5e-5 px and scores 6e-8 apart: the gap is
    the forward's, not the NMS's.
- The same against JAX on one file of each kind ``NEW_KINDS``: a lossless
  JPEG, VP8, VP8L and VP8X+ALPH WebPs, LZW, Deflate-tiled, palette and
  16-bit TIFFs (``tools/format_files.py``), at seed 47, the one of 13..55
  whose margins hold on them; one file of each newer format at seed 45,
  and a TIFF of each kind ``TIFF_KINDS`` (JPEG compression, YCbCr,
  CMYK, CIELab, CCITT fax, FillOrder 2, old-style LZW, ThunderScan,
  signed samples, SGILog) at seed 15, the first of 13..55 whose margins
  hold; six AVIF files ``AVIF_KINDS`` at seed 29.
- ``main`` end to end on a port checkpoint, over every decodable fixture
  (progressive and 1280x720 ones too): one JSON line per image equal to
  ``predict_images`` on the restored state, one PNG panel per image.
- ``main`` streams: on [good, cut, good] the first image's line is
  printed and its PNG written before the second (cut inside its headers)
  raises ``JpegError``.
- ``resize_input`` equals the JAX CLI's input bit for bit, with the host
  library and without it, over the decodable fixtures at 64 and 416 px.
- ``write_png`` read back by PIL, equal.
- ``--export`` to a path that cannot be written raises before any image
  is served (``tests/test_torch_port_export.py`` writes and reloads).
"""

import json
import os
import re
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu.data.pipeline import _resize
from objectdetectionpl_tpu.train import loop as jax_loop
from objectdetectionpl_tpu_torch.cli import predict
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.tools import fixture_trees, format_files
from objectdetectionpl_tpu_torch.train import loop
from objectdetectionpl_tpu_torch.utils import viz
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_trainer import (_calibrated_stats, _decode,
                                     _draw_variables)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "config.yaml")
IMG = 64
CONF = 0.75
BOX_TOL = dict(rtol=1e-4, atol=1e-3)
SCORE_TOL = dict(rtol=1e-4, atol=1e-6)
# the port's decode and NMS against JAX's on the port's own head maps
CHAIN_TOL = dict(rtol=1e-6, atol=1e-4)
# the weights' seeds: every seed from 13 to 55 at which the asserted
# margins hold on these inputs
SEEDS = (39, 44, 55)
ALL_PATHS = [str(fixture_trees.TESTDATA / n)
             for n in fixture_trees.decodable()]
# The JAX parity's inputs: the fixtures its weights and asserted margins
# were drawn for.  The BN statistics are calibrated on the inputs, so
# another input moves every score; the progressive and 1280x720 fixtures
# go through ``main`` (port against port) instead.
LATER = ("progressive_420_q75_160x120.jpg",) + fixture_trees.BDD_FRAMES
PATHS = [p for p in ALL_PATHS if os.path.basename(p) not in LATER]


def _jax_records(jt, paths, inputs):
    """The JAX CLI's loop (``objectdetectionpl_tpu/cli/predict.py``) on
    the given float inputs: records and the unrounded rows."""
    out, raw = [], []
    for path, x in zip(paths, inputs):
        res = jt.predict_step(jt.state, jnp.asarray(x))
        v = np.asarray(res.valid[0])
        boxes, scores = np.asarray(res.boxes[0]), np.asarray(res.scores[0])
        out.append({
            "image": path,
            "boxes_xyxy": boxes[v].round(2).tolist(),
            "scores": scores[v].round(4).tolist(),
            "labels": [jt.classes[int(c)]
                       for c in np.asarray(res.labels[0])[v]]})
        raw.append((boxes[v], scores[v]))
    return out, raw


def _bridged_trainers(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_loop.summary_lib, "save_summary",
                        lambda *a, **k: None)
    kw = dict(data_module="Synthetic", synthetic_size=4, batch_size=2,
              img_size=IMG, model_name="YOLOv5", mesh_shape=(1, 1),
              conf_thres=CONF)
    jt = jax_loop.Trainer(JaxConfig(log_dir=str(tmp_path / "jax"), **kw))
    pt = loop.Trainer(Config(log_dir=str(tmp_path / "port"), **kw),
                      device="cpu")
    assert jt.state.ema_params is None and pt.state.ema_params is None
    return jt, pt


def _draw_weights(jt, pt, inputs, init_stats, seed):
    """Both trainers on the weights drawn from ``seed``, the BN statistics
    calibrated on ``inputs``; asserts the margins on JAX's forward."""
    params = _draw_variables(jt.state.params, seed=seed)
    pt.model.load_state_dict(state_dict_from_flax(params, init_stats))
    stats = _calibrated_stats(pt.model, init_stats, np.concatenate(inputs))
    jt.state = jt.state.replace(params=params, batch_stats=stats)
    pt.model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    # no candidate near conf_thres, scores well apart, in every image
    for x in inputs:
        out = jt.model.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), train=False)
        dec = np.asarray(_decode("YOLOv5", out))[0]
        obj = dec[:, 4]
        assert np.abs(obj - CONF).min() > 1e-3
        s = np.sort((obj * dec[:, 5:].max(-1))[obj >= CONF])[::-1]
        assert (-np.diff(s) > 3e-4 * s[1:]).all()
    return params, stats


def _forward_noise(jt, params, stats, x, heads) -> float:
    """The largest difference between the candidate boxes that XLA's and
    torch's forwards decode to (JAX's decode of both), over the rows above
    conf_thres in either."""
    want = np.asarray(_decode("YOLOv5", jt.model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False)))[0]
    got = np.asarray(_decode("YOLOv5", [jnp.asarray(h.numpy())
                                        for h in heads]))[0]
    rows = (want[:, 4] >= CONF) | (got[:, 4] >= CONF)
    return float(np.abs(got[rows, :4] - want[rows, :4]).max(initial=0.0))


def test_predict_images_equals_jax(tmp_path, monkeypatch):
    _assert_predict_equals_jax(tmp_path, monkeypatch, PATHS, SEEDS)


# One file of each kind this slice added to the reader, from
# ``tools/format_files.py``, and the seed at which the margins of
# ``_draw_weights`` hold on them: of 13 to 55, 47 alone
NEW_KINDS = ("jpeg_lossless", "webp_lossy", "webp_lossless", "webp_alpha",
             "tiff_lzw", "tiff_deflate_tiled", "tiff_palette", "tiff_16bit")
NEW_KIND_SEEDS = (47,)
# one file of each format read since, on weights of their own: the BN
# statistics are calibrated on the group, and seed 45 keeps every
# candidate's margins on these inputs
NEWER_KINDS = ("jp2_lossy", "j2k_styles", "gif_interlaced_offset", "ppm",
               "pam", "pfm", "ras_map8", "hdr")
NEWER_KIND_SEEDS = (45,)
# one TIFF of each kind of JPEG compression, photometric and codec read
# since (JPEG in a strip, strips and tiles, JPEG CMYK, YCbCr units, CMYK,
# CIELab, CCITT RLE, Group 3 and Group 4, FillOrder 2, old-style LZW,
# ThunderScan, signed samples, SGILog), at seed 15, the first of 13..55
# whose margins hold on them (45 and 47 do not)
TIFF_KINDS = ("tiff_jpeg_ycbcr", "tiff_jpeg_strips", "tiff_jpeg_tiles",
              "tiff_jpeg_cmyk", "tiff_ycbcr", "tiff_ycbcr_44_tiles",
              "tiff_cmyk", "tiff_cielab", "tiff_g3_2d", "tiff_g4",
              "tiff_ccitt_rle", "tiff_fillorder2", "tiff_lzw_old",
              "tiff_thunderscan", "tiff_signed", "tiff_logluv", "tiff_logl")
TIFF_KIND_SEEDS = (15,)
# AVIF files (cv2.imwrite's default, Pillow's default, 4:0:0, an odd size,
# 500x375, superres with loop restoration) at seed 29, the one of 13..55
# at which their margins hold (19 held on the first five)
AVIF_KINDS = ("avif_cv2", "avif_pillow", "avif_400", "avif_odd",
              "avif_500x375", "avif_superres")
AVIF_KIND_SEEDS = (29,)


def test_predict_new_formats_equal_jax(tmp_path, monkeypatch):
    """``predict_images`` on a lossless JPEG, WebPs, TIFFs, a file of
    each newer format (JPEG 2000, GIF, PNM, PAM, PFM, Sun raster,
    Radiance HDR), a TIFF of each newer kind and AVIF files against the
    JAX CLI's chain on its cv2 decodes, as for the baseline fixtures."""
    paths = format_files.write_format_files(tmp_path / "formats")
    for n, (kinds, seeds) in enumerate(((NEW_KINDS, NEW_KIND_SEEDS),
                                        (NEWER_KINDS, NEWER_KIND_SEEDS),
                                        (TIFF_KINDS, TIFF_KIND_SEEDS),
                                        (AVIF_KINDS, AVIF_KIND_SEEDS))):
        _assert_predict_equals_jax(tmp_path / str(n), monkeypatch,
                                   [paths[k] for k in kinds], seeds)


def _assert_predict_equals_jax(tmp_path, monkeypatch, paths, seeds):
    # the JAX CLI's input (cli/predict.py): cv2's uint8 resize, then /255
    inputs = [_resize(load_image_rgb(p), IMG).astype(np.float32)[None] / 255.0
              for p in paths]
    jt, pt = _bridged_trainers(tmp_path, monkeypatch)
    init_stats = jt.state.batch_stats
    for seed in seeds:
        params, stats = _draw_weights(jt, pt, inputs, init_stats, seed)
        got = predict.predict_images(pt, paths)
        want, raw = _jax_records(jt, paths, inputs)
        assert len(got) == len(want) == len(paths)
        assert sum(len(w["labels"]) for w in want) >= len(paths)
        # the unrounded rows, taken again from the port's predict_step
        for g, w, (wb, ws), x in zip(got, want, raw, inputs):
            assert g["image"] == w["image"]
            assert g["labels"] == w["labels"]
            res = pt.predict_step(pt.state, torch.from_numpy(x))
            v = res.valid[0].numpy()
            boxes, scores = res.boxes[0].numpy()[v], res.scores[0].numpy()[v]
            # the port's decode and NMS against JAX's on the same head maps
            with torch.inference_mode():
                heads = pt.model(torch.from_numpy(x))
            chain = jt.postprocess([jnp.asarray(h.numpy()) for h in heads])
            cv = np.asarray(chain.valid[0])
            np.testing.assert_array_equal(v, cv)
            np.testing.assert_array_equal(res.labels[0].numpy()[v],
                                          np.asarray(chain.labels[0])[cv])
            np.testing.assert_allclose(boxes, np.asarray(chain.boxes[0])[cv],
                                       **CHAIN_TOL)
            np.testing.assert_allclose(
                scores, np.asarray(chain.scores[0])[cv], **CHAIN_TOL)
            # end to end: a merged box moves as far as its candidates do
            # between the two forwards, past BOX_TOL's atol at some seeds
            atol = max(BOX_TOL["atol"],
                       _forward_noise(jt, params, stats, x, heads))
            np.testing.assert_allclose(boxes, wb, rtol=BOX_TOL["rtol"],
                                       atol=atol)
            np.testing.assert_allclose(scores, ws, **SCORE_TOL)
            gb, wb2 = np.asarray(g["boxes_xyxy"]), np.asarray(w["boxes_xyxy"])
            assert gb.shape == wb2.shape
            np.testing.assert_allclose(gb, wb2, rtol=BOX_TOL["rtol"],
                                       atol=0.01 + atol)
            np.testing.assert_allclose(g["scores"], w["scores"],
                                       rtol=SCORE_TOL["rtol"],
                                       atol=1e-4 + SCORE_TOL["atol"])


def test_resize_input_is_the_loaders_resize(monkeypatch):
    """``resize_input`` is the JAX CLI's input bit for bit: the host
    library's uint8 resize, and without it ``pipeline.numpy_preproc_u8``,
    then /255 in float32."""
    def check():
        for path in ALL_PATHS:
            img = load_image_rgb(path)
            for size in (IMG, 416):
                want = _resize(img, size).astype(np.float32)[None] / 255.0
                got = predict.resize_input(img, size)
                assert got.shape == (1, size, size, 3)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)

    assert native.available()
    check()
    with monkeypatch.context() as m:
        m.setattr(native, "_lib", None)
        m.setattr(native, "_load_failed", True)
        assert not native.available()
        check()


def _png_size(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    return struct.unpack(">II", data[16:24])


def test_main_end_to_end(tmp_path, capsys):
    sets = ["--set", "model_name", "YOLOv5", "--set", "img_size", str(IMG),
            "--set", "log_dir", str(tmp_path / "logs"),
            "--set", "conf_thres", "0.3"]
    cfg_over = {"model_name": "YOLOv5", "img_size": IMG, "conf_thres": 0.3,
                "log_dir": str(tmp_path / "logs")}
    from objectdetectionpl_tpu_torch.config import load_config
    trainer = loop.Trainer(load_config(YAML, cfg_over), device="cpu")
    with torch.no_grad():                   # a state that differs from init
        for p in trainer.model.parameters():
            p.add_(0.01)
    trainer.ckpt.save(0, trainer.state, 1.0)
    trainer.ckpt.wait()
    want = predict.predict_images(trainer, ALL_PATHS)
    trainer.ckpt.close()
    trainer.writer.close()
    capsys.readouterr()

    out_dir = tmp_path / "preds"
    got = predict.main([YAML, *sets, "--device", "cpu", "--images",
                        *ALL_PATHS,
                        "--out-dir", str(out_dir)])
    stdout = capsys.readouterr().out
    assert "restored best checkpoint" in stdout
    lines = [json.loads(line) for line in stdout.splitlines()
             if line.startswith("{")]
    assert lines == got == want
    for path in ALL_PATHS:
        stem = os.path.splitext(os.path.basename(path))[0]
        png = out_dir / f"{stem}_pred.png"
        assert _png_size(png) == (IMG, IMG)
        assert np.asarray(Image.open(png)).shape == (IMG, IMG, 3)


def test_main_prints_and_writes_each_image_before_the_next(tmp_path,
                                                           capsys):
    """On [good, cut, good] the first image's JSON line is printed and its
    PNG written before the file cut inside its headers (which cv2 refuses
    too) raises, as the JAX CLI streams image by image."""
    good, other = PATHS[0], PATHS[1]
    bad = str(tmp_path / "header_cut.jpg")
    with open(good, "rb") as f:
        open(bad, "wb").write(f.read()[:100])
    out_dir = tmp_path / "preds"
    with pytest.raises(native.JpegError, match=f"^{re.escape(bad)}: "):
        predict.main([YAML, "--set", "model_name", "YOLOv5",
                      "--set", "img_size", str(IMG),
                      "--set", "log_dir", str(tmp_path / "logs"),
                      "--device", "cpu", "--images", good, bad, other,
                      "--out-dir", str(out_dir)])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [rec["image"] for rec in lines] == [good]
    stem = os.path.splitext(os.path.basename(good))[0]
    assert os.listdir(out_dir) == [f"{stem}_pred.png"]
    assert _png_size(out_dir / f"{stem}_pred.png") == (IMG, IMG)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (64, 48)])
def test_write_png_reads_back(tmp_path, shape):
    rgb = np.random.RandomState(shape[0]).randint(
        0, 256, (*shape, 3)).astype(np.uint8)
    path = tmp_path / "x.png"
    viz.write_png(str(path), rgb)
    back = Image.open(path)
    assert back.mode == "RGB" and back.size == (shape[1], shape[0])
    np.testing.assert_array_equal(np.asarray(back), rgb)
    assert _png_size(path) == (shape[1], shape[0])
    data = path.read_bytes()                  # filter 0 on every row
    idat = data.index(b"IDAT")
    n = struct.unpack(">I", data[idat - 4:idat])[0]
    raw = zlib.decompress(data[idat + 4:idat + 4 + n])
    assert all(raw[r * (3 * shape[1] + 1)] == 0 for r in range(shape[0]))
    with pytest.raises(ValueError, match="uint8"):
        viz.write_png(str(path), rgb.astype(np.float32))


def test_export_raises(tmp_path, capsys):
    """``--export`` runs before any image is served and has no fallback: a
    program that cannot be written raises, and nothing is predicted."""
    missing = tmp_path / "no_such_dir" / "model.pt2"
    with pytest.raises((FileNotFoundError, RuntimeError)):
        predict.main([YAML, "--set", "model_name", "YOLOv5",
                      "--set", "img_size", str(IMG),
                      "--set", "log_dir", str(tmp_path / "logs"),
                      "--device", "cpu", "--export", str(missing),
                      "--images", PATHS[0]])
    out = capsys.readouterr().out
    assert "exported serving graph" not in out and "{" not in out
    assert not missing.exists()
