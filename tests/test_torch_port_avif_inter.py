"""The AV1 inter tools libaom 3.6's encoder reaches only through frame
resizing, a rewritten frame header or a lost temporal unit, and alpha
items on a grid's tiles, through the port's reader
(``data/formats.py::read_avif`` over ``csrc/av1_decode.cc``) against
JAX's ``load_image_rgb`` -- cv2 5.0 over libavif 1.4.2 and its libaom --
bit for bit, or both refusing:

- compound prediction from a scaled reference: sequences through
  libaom's frame resizing (every frame but the key frame at 8/9 .. 8/16
  of its size) and superres sequences (whose every inter block is
  scaled), 8 and 10 bits, 4:2:0 and 4:4:4; and the compound candidate
  search past a block's shorter side, which a scaled 12-bit 4:2:2
  sequence showed (libaom scans both neighbours as far as the shorter
  side);
- global motion: one inter frame header rewritten
  (``format_files.with_global_motion``) to give a reference a rotation
  and zoom, an affine or a translation model, or one whose shear the
  warp filter does not take; its GLOBALMV blocks warp (or move by the
  model's vector), 8 and 10 bits, 4:2:0 and 4:4:4;
- a reference slot filled in for a lost frame: an error-resilient frame
  (``AOM_EFLAG_ERROR_RESILIENT`` on its own, so no frame ids) after a
  temporal unit cut out, predicting from the grey slot or not; later
  frames that read the slot's state beyond its samples (the state of
  the frame libaom's buffer held before);
- libavif's alpha grid over alpha items on each tile of a grid, at 8,
  10 and 12 bits, premultiplied or not, and the layouts libavif refuses
  or reads without alpha;
- the committed files of these tools (``format_files.avif_inter_files``).

Every stream is written here by the system libaom through ctypes; the
cases skip where it is absent.  Each case shows, by ``native._av1``'s
counts, that the tool ran.  The file runs in about 30 s on one worker.
"""

import concurrent.futures
import functools
import multiprocessing

import cv2
import numpy as np
import pytest

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import formats, native
from objectdetectionpl_tpu_torch.tools import av1_tables, format_files
from objectdetectionpl_tpu_torch.tools.format_files import (
    AOM_EFLAG_ERROR_RESILIENT, GM_ROTZOOM, GM_ROTZOOM_WIDE, av1_obus,
    av1c_bytes, avif_bytes, avif_grid_bytes, deepen, mosaic_frames,
    moving_frames, temporal_units, with_global_motion)

needs_libaom = pytest.mark.skipif(av1_tables.find_libaom() is None,
                                  reason="no libaom.so.3 to write streams")

INTER_FIXTURES = ("avif_scaled_compound", "avif_global_motion",
                  "avif_lost_frame", "avif_alpha_grid")


@functools.lru_cache(maxsize=None)
def _encoder() -> concurrent.futures.ProcessPoolExecutor:
    return concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))


def aom_encode(*args, **kw) -> bytes:
    """``format_files.aom_encode`` in a child process (libaom 3.6's
    encoder aborts its process on some settings; the child's death fails
    the case): its OBUs."""
    return _encoder().submit(format_files.aom_encode, *args, **kw).result()


def _file(tmp_path, data: bytes, name="x.avif") -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _same_as_cv2(path: str) -> np.ndarray:
    want = load_image_rgb(path)
    got = native.decode_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _both_refuse(path: str) -> None:
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None
    with pytest.raises(native.ImageError, match=f"^{path}"):
        native.decode_image(path)


def _box(stream: bytes, depth: int = 8, sub: str = "4:2:0") -> bytes:
    """``stream`` in an AVIF whose ispe is its shown frame's size."""
    info = native.av1_probe(stream)
    return avif_bytes(stream, info["width"], info["height"],
                      av1c_bytes(sub, depth), pixi=(depth,) * 3)


@functools.lru_cache(maxsize=None)
def _rgb() -> np.ndarray:
    return native.decode_one(str(format_files.TESTDATA / format_files.BASE))


def _item(data: bytes) -> bytes:
    """The primary item's data of a file ``avif_bytes`` wrote."""
    boxes = list(formats._jp2_boxes(data, 0, len(data)))
    meta = [formats._avif_meta(data, a, s) for k, a, s in boxes
            if k == b"meta"][0]
    return formats._avif_item_data(data, meta, meta["pitm"])


# ---------------------------------------------------------------------------
# compound prediction from a scaled reference

# case: (bit depth, subsampling, the crops' step (rows, columns) a frame,
# aom_encode's resize or superres)
SCALED = {
    "resize_9": (8, "4:2:0", (2, 3), {"resize": (1, 9)}),
    "resize_12": (8, "4:2:0", (-3, 2), {"resize": (1, 12)}),
    "resize_16": (8, "4:2:0", (2, 3), {"resize": (1, 16)}),
    "resize_12_10bit": (10, "4:2:0", (-3, 2), {"resize": (1, 12)}),
    "resize_12_444": (8, "4:4:4", (-3, 2), {"resize": (1, 12)}),
    "superres_9": (8, "4:2:0", (-3, 2), {"superres": 9}),
    "superres_16": (8, "4:2:0", (2, 3), {"superres": 16}),
    "superres_9_10bit": (10, "4:2:0", (-3, 2), {"superres": 9}),
}


@needs_libaom
@pytest.mark.parametrize("case", sorted(SCALED))
def test_scaled_compound_as_cv2(tmp_path, case):
    """Six 96x64 crops moving a few samples a frame (hidden alt-refs,
    compound prediction): through frame resizing the inter frames are
    coded at 8/d of the key frame's size, through superres at a width
    of 8/d; in both, blocks predict from two references, at least one
    of them scaled, and the file reads as cv2 reads it."""
    depth, sub, (dy, dx), kw = SCALED[case]
    fr = moving_frames(_rgb(), 6, 150, 200, 64, 96, dy, dx, sub)
    if depth > 8:
        fr = [deepen(f, depth) for f in fr]
    stream = aom_encode(fr[0], sub, sequence=fr[1:], lag=5, bit_depth=depth,
                        options={"cpu-used": 1, "cq-level": 25}, **kw)
    _, info = native._av1(stream)
    assert info["scaled_compound_blocks"] > 0, info
    _same_as_cv2(_file(tmp_path, _box(stream, depth, sub)))


@needs_libaom
def test_compound_candidates_past_the_shorter_side(tmp_path):
    """A 12-bit 4:2:2 sequence of a zooming 196x179 crop coded at half
    its size (loop filters off): a 16x8 compound block with one
    candidate pair takes its second from the neighbours above and left
    as far as its shorter side, as libaom's setup_ref_mv_list does; the
    port once scanned the row above along the block's whole width,
    predicted that block from another pair and read the next frame's
    blocks out of step (it refused the file)."""
    rgb = np.ascontiguousarray(_rgb())
    frames = []
    for k in range(5):
        m = cv2.getRotationMatrix2D((196 + 98, 42 + 89.5), 0.0, 1.06 ** k)
        m[0, 2] -= 8 * k
        m[1, 2] -= 5 * k
        img = cv2.warpAffine(rgb, m, (500, 375), borderMode=cv2.BORDER_REFLECT)
        frames.append(deepen(format_files._yuv(img[42:221, 196:392],
                                               "4:2:2"), 12))
    stream = aom_encode(frames[0], "4:2:2", sequence=frames[1:], lag=6,
                        bit_depth=12, resize=(1, 16), options={
                            "cpu-used": 0, "cq-level": 7,
                            "enable-masked-comp": 0,
                            "enable-dist-wtd-comp": 0, "enable-obmc": 0,
                            "enable-warped-motion": 0,
                            "enable-interintra-comp": 1,
                            "enable-ref-frame-mvs": 1,
                            "enable-dual-filter": 0, "enable-cdef": 0,
                            "enable-restoration": 0,
                            "loopfilter-control": 0})
    _, info = native._av1(stream)
    assert info["scaled_compound_blocks"] > 0 and info["temporal_mvs"] > 0
    _same_as_cv2(_file(tmp_path, _box(stream, 12, "4:2:2")))


# ---------------------------------------------------------------------------
# global motion

ONE = 1 << 16
# the models: the first vectors of a block's centre round to zero in a
# 128x96 frame (the candidate lists keep their values, the warp moves a
# block by up to 1/16 sample); the others' up to 1/8 sample (some
# candidates change), the invalid shear's further
MODELS = {
    "rotzoom_small": GM_ROTZOOM,
    "rotzoom": GM_ROTZOOM_WIDE,
    "affine": ("affine", [-6144, -6144, ONE + 96, 0, 0, ONE + 128]),
    "affine_444": ("affine", [-6144, -2048, ONE + 64, 32, -32, ONE + 64]),
    "translation": ("translation", [0, 0, ONE, 0, 0, ONE]),
    "translation_moved": ("translation", [1 << 14, -(1 << 14), ONE, 0, 0,
                                          ONE]),
    "invalid_shear": ("rotzoom", [0, 0, ONE + 8000, 7000, 0, 0]),
}

# case: (model, subsampling, bit depth, the mosaic's seed, the inter
# frame rewritten, whether the warp changes the samples)
GLOBAL = {
    "rotzoom": ("rotzoom", "4:2:0", 8, 3, 0, True),
    "rotzoom_10bit": ("rotzoom", "4:2:0", 10, 2, 0, True),
    "rotzoom_small": ("rotzoom_small", "4:2:0", 8, 1, 0, False),
    "rotzoom_small_444": ("rotzoom_small", "4:4:4", 8, 2, 1, False),
    "affine": ("affine", "4:2:0", 8, 3, 0, True),
    "affine_444": ("affine_444", "4:4:4", 8, 2, 1, True),
    "translation": ("translation", "4:2:0", 8, 2, 0, False),
    "translation_moved_10bit": ("translation_moved", "4:2:0", 10, 1, 1,
                                False),
    "invalid_shear": ("invalid_shear", "4:2:0", 8, 3, 0, False),
    "invalid_shear_10bit": ("invalid_shear", "4:2:0", 10, 3, 2, False),
}


@functools.lru_cache(maxsize=None)
def _mosaic_stream(sub: str, depth: int, seed: int) -> bytes:
    """Realtime frames of a 128x96 mosaic (static tiles amid moving ones,
    which libaom codes as GLOBALMV), OBMC and local warp off."""
    fr = mosaic_frames(_rgb(), 4, 96, 128, seed, sub=sub)
    if depth > 8:
        fr = [deepen(f, depth) for f in fr]
    return aom_encode(fr[0], sub, sequence=fr[1:], usage=1, bit_depth=depth,
                      options={"cpu-used": 8, "cq-level": 30,
                               "enable-obmc": 0, "enable-warped-motion": 0})


@needs_libaom
@pytest.mark.parametrize("case", sorted(GLOBAL))
def test_global_motion_as_cv2(tmp_path, case):
    """LAST's global motion in one inter frame header: a rotation and
    zoom or an affine model warps its GLOBALMV blocks (by more than 1/16
    sample, to other pixels than the stream's own); a translation, or a
    model whose shear the warp filter does not take, moves them by the
    model's vector; every file reads as cv2 reads it."""
    model, sub, depth, seed, frame, differs = GLOBAL[case]
    stream = _mosaic_stream(sub, depth, seed)
    rewritten = with_global_motion(stream, {1: MODELS[model]}, frame=frame)
    _, info = native._av1(rewritten)
    warps = MODELS[model][0] in ("rotzoom", "affine") and \
        model != "invalid_shear"
    assert info["global_warp_blocks" if warps else "global_shift_blocks"] \
        > 0, info
    assert info["global_warp_blocks" if not warps else
                "global_shift_blocks"] == 0, info
    got = _same_as_cv2(_file(tmp_path, _box(rewritten, depth, sub)))
    if differs:
        plain = _same_as_cv2(_file(tmp_path, _box(stream, depth, sub),
                                   "plain.avif"))
        assert not np.array_equal(got, plain)


@needs_libaom
def test_global_motion_rewriter():
    """``with_global_motion`` with every reference IDENTITY gives libaom's
    own bits back (its headers carry IDENTITY); a model lengthens the
    header, moves the tile data to the new byte boundary and rewrites
    the OBU's size; values off their grid or out of range are refused."""
    stream = _mosaic_stream("4:2:0", 8, 1)
    marks = [m for m in native.av1_frame_marks(stream)
             if m["gm_start"] >= 0 and m["frame_type"] in (1, 3)]
    assert len(marks) == 3
    for f in range(3):
        assert with_global_motion(stream, {}, frame=f) == stream
        assert marks[f]["gm_end"] - marks[f]["gm_start"] == 7
    affine = with_global_motion(stream, {r: MODELS["affine"]
                                         for r in range(1, 8)}, frame=2)
    assert len(affine) > len(stream)
    assert [k for k, _, _ in av1_obus(affine)] == \
        [k for k, _, _ in av1_obus(stream)]
    new = native.av1_frame_marks(affine)[-1]
    assert new["gm_end"] - new["gm_start"] > 7 * 20
    assert affine[new["payload"] + (new["header_end"] + 7) // 8:] == \
        stream[marks[2]["payload"] + (marks[2]["header_end"] + 7) // 8:]
    with pytest.raises(ValueError, match="not on its grid"):
        with_global_motion(stream, {1: ("rotzoom", [1, 0, ONE, 0, 0, ONE])})
    with pytest.raises(ValueError, match="out of range"):
        with_global_motion(stream, {1: ("rotzoom", [0, 0, ONE + 8194, 0,
                                                    0, ONE])})


# ---------------------------------------------------------------------------
# a reference slot filled in for a lost frame

# libaom's AOM_EFLAG_NO_REF_* but ALTREF: the frame refers to one slot
ALTREF_ONLY = sum(1 << b for b in (16, 17, 18, 19, 21, 22))


def _lost(depth: int = 8, sub: str = "4:2:0", flags: int = 0,
          drop: int = 3, er_at: int = 4, lag: int = 0) -> bytes:
    """Five 128x96 crops moving by (2, 3) a frame, the one at ``er_at``
    error-resilient (with ``flags``), the temporal unit ``drop`` cut
    out."""
    fr = moving_frames(_rgb(), 5, 150, 200, 96, 128, 2, 3, sub)
    if depth > 8:
        fr = [deepen(f, depth) for f in fr]
    every = [0] * 5
    every[er_at] = AOM_EFLAG_ERROR_RESILIENT | flags
    units = temporal_units(aom_encode(
        fr[0], sub, sequence=fr[1:], bit_depth=depth, flags=every, lag=lag,
        options={"cpu-used": 4, "cq-level": 30}))
    return b"".join(u for i, u in enumerate(units) if i != drop)


# case: (bit depth, subsampling, the last frame's flags, whether it
# predicts from the grey slot)
LOST = {
    "predicts_from_grey": (8, "4:2:0", 0, True),
    "predicts_from_grey_10bit": (10, "4:2:0", 0, True),
    "predicts_from_grey_444": (8, "4:4:4", 0, True),
    "altref_only": (8, "4:2:0", ALTREF_ONLY, False),
    "altref_only_10bit": (10, "4:2:0", ALTREF_ONLY, False),
}


@needs_libaom
@pytest.mark.parametrize("case", sorted(LOST))
def test_lost_frame_as_cv2(tmp_path, case):
    """The frame before an error-resilient one cut out: its order hints
    name a frame the LAST slot never held, and libaom fills that slot
    with a frame of the sequence's size at 1 << (BitDepth - 1); the
    error-resilient frame predicts from it (or, referring to ALTREF
    alone, does not), and the file reads as cv2 reads it."""
    depth, sub, flags, grey = LOST[case]
    stream = _lost(depth, sub, flags)
    _, info = native._av1(stream)
    assert info["grey_slots"] > 0, info
    assert (info["grey_blocks"] > 0) == grey, info
    got = _same_as_cv2(_file(tmp_path, _box(stream, depth, sub)))
    whole = _lost(depth, sub, flags, drop=-1)
    assert native._av1(whole)[1]["grey_slots"] == 0
    same = np.array_equal(got, _same_as_cv2(_file(
        tmp_path, _box(whole, depth, sub), "whole.avif")))
    assert same != grey


@needs_libaom
@pytest.mark.parametrize("drop", [1, 2])
def test_lost_frame_state_as_cv2(tmp_path, drop):
    """Frames after the error-resilient one that project their motion
    field from the grey slot: libaom reads the state of the frame its
    buffer held before (motion vectors, frame type, order hints), which
    the port finds by counting libaom's buffers; the file reads as cv2
    reads it."""
    stream = _lost(er_at=3, drop=drop, lag=3)
    _, info = native._av1(stream)
    assert info["grey_slots"] > 0 and info["temporal_mvs"] > 0, info
    _same_as_cv2(_file(tmp_path, _box(stream)))


# ---------------------------------------------------------------------------
# alpha items on a grid's tiles

def _grid_tiles(depth: int, sub: str, n: int, alpha_depth=None):
    """n 64x64 colour tiles (crops of the fixture) and an alpha item for
    each (a seeded ramp; ``alpha_depth`` the alphas' depth)."""
    a_depth = alpha_depth or depth
    tiles, alphas = [], []
    for i in range(n):
        planes = format_files._yuv(_rgb()[40:104, 180 + 64 * i:244 + 64 * i],
                                   sub)
        if depth > 8:
            planes = deepen(planes, depth)
        tiles.append(aom_encode(planes, sub, bit_depth=depth, options={
            "cq-level": 25, "cpu-used": 5}))
        y, x = np.mgrid[0:64, 0:64]
        top = (1 << a_depth) - 1
        alpha = ((x * 3 + y * 5 + 97 * i) * (top + 1) // 256 % (top + 1))
        alphas.append((aom_encode([alpha.astype(np.uint16)], "4:0:0",
                                  bit_depth=a_depth, options={
                                      "cq-level": 5, "cpu-used": 5}),
                       av1c_bytes("4:0:0", a_depth)))
    return tiles, alphas


@needs_libaom
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("prem", [False, True])
def test_alpha_grid_as_cv2(tmp_path, depth, prem):
    """A 1x2 grid whose tiles each have an alpha item: libavif assembles
    them into an alpha grid of the colour grid's layout (a new item,
    the largest item id + 1, which a prem reference from the colour
    grid names): at 10 and 12 bits its presence alone changes libavif's
    route, premultiplied its values change the colours."""
    tiles, alphas = _grid_tiles(depth, "4:2:0", 2)
    av1c = av1c_bytes("4:2:0", depth)
    plain = _same_as_cv2(_file(tmp_path, avif_grid_bytes(
        tiles, 64, 64, av1c, 1, 2, depth=depth), "plain.avif"))
    got = _same_as_cv2(_file(tmp_path, avif_grid_bytes(
        tiles, 64, 64, av1c, 1, 2, depth=depth, alpha=alphas,
        iref_extra=((b"prem", 3, 6),) if prem else ())))
    assert np.array_equal(got, plain) == (depth == 8 and not prem)


@needs_libaom
def test_alpha_grid_layouts_as_cv2(tmp_path):
    """What libavif does with other alpha items on tiles: a tile without
    alpha leaves the grid without alpha; a tile with two alpha items,
    and alpha items of another bit depth, make files cv2 refuses; a
    prem reference to another item leaves the alpha not premultiplied;
    a 4:4:4 grid cropped to 120x100."""
    tiles, alphas = _grid_tiles(10, "4:2:0", 2)
    av1c = av1c_bytes("4:2:0", 10)
    plain = _same_as_cv2(_file(tmp_path, avif_grid_bytes(
        tiles, 64, 64, av1c, 1, 2, depth=10), "plain.avif"))
    with_alpha = _same_as_cv2(_file(tmp_path, avif_grid_bytes(
        tiles, 64, 64, av1c, 1, 2, depth=10, alpha=alphas), "alpha.avif"))
    assert not np.array_equal(plain, with_alpha)
    one = _same_as_cv2(_file(tmp_path, avif_grid_bytes(
        tiles, 64, 64, av1c, 1, 2, depth=10, alpha=alphas[:1]), "one.avif"))
    np.testing.assert_array_equal(one, plain)
    np.testing.assert_array_equal(with_alpha, _same_as_cv2(_file(
        tmp_path, avif_grid_bytes(tiles, 64, 64, av1c, 1, 2, depth=10,
                                  alpha=alphas, iref_extra=((b"prem", 3, 5),)),
        "prem_elsewhere.avif")))
    _both_refuse(_file(tmp_path, avif_grid_bytes(
        tiles, 64, 64, av1c, 1, 2, depth=10, alpha=alphas + alphas[:1],
        iref_extra=((b"auxl", 6, 1),)), "two.avif"))
    _, deep = _grid_tiles(10, "4:2:0", 2, alpha_depth=12)
    _both_refuse(_file(tmp_path, avif_grid_bytes(
        tiles, 64, 64, av1c, 1, 2, depth=10, alpha=deep), "deep.avif"))
    t444, a444 = _grid_tiles(12, "4:4:4", 2)
    _same_as_cv2(_file(tmp_path, avif_grid_bytes(
        t444, 64, 64, av1c_bytes("4:4:4", 12), 1, 2, output=(120, 64),
        depth=12, alpha=a444, iref_extra=((b"prem", 3, 6),)), "444.avif"))


# ---------------------------------------------------------------------------
# the committed files

@pytest.mark.parametrize("kind", INTER_FIXTURES)
def test_inter_fixtures_as_cv2(kind):
    """Each committed file reads as cv2 reads it, its tool counted."""
    path = format_files.COMMITTED[kind]
    _same_as_cv2(str(path))
    if kind == "avif_alpha_grid":
        return
    _, info = native._av1(_item(path.read_bytes()))
    count = {"avif_scaled_compound": "scaled_compound_blocks",
             "avif_global_motion": "global_warp_blocks",
             "avif_lost_frame": "grey_blocks"}[kind]
    assert info[count] > 0, info


@needs_libaom
def test_committed_inter_fixtures():
    """``format_files.avif_inter_files`` is the recipe of the committed
    files (``chip_smoke.py formats`` serves them): the same bytes
    again."""
    files = format_files.avif_inter_files()
    assert sorted(files) == sorted(INTER_FIXTURES)
    for kind, data in files.items():
        assert format_files.COMMITTED[kind].read_bytes() == data, kind
