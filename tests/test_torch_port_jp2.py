"""JPEG 2000 files through the port's reader (``csrc/jp2_decode.cc`` and
``data/formats.py::read_jp2``) against the JAX package's ``load_image_rgb``
(``cv2.imread``: cv2's bundled OpenJPEG 2.5.3 and its conversion to 8-bit
BGR), bit for bit, as JP2 files and as raw J2K codestreams, under their
own names and under a ``.jpg`` one.

- ``cv2.imwrite``: its default lossy write and compression rates up to
  lossless, grey and colour, 8- and 16-bit;
- Pillow's encoder (OpenJPEG 2.5.4): 5/3 and 9/7, MCT on and off, tiles,
  quality layers, the five progression orders, precincts, code-block
  sizes, resolution counts; grey, grey + alpha, RGB, RGBA, 16-bit grey;
- the system libopenjp2 as an encoder, driven through ctypes: every
  code-block style bit (bypass, reset, termall, vertically causal,
  predictable termination, segmentation symbols) alone and together, SOP
  and EPH markers, tile-parts split by resolution, layer and component,
  ROI (RGN max-shift), POC, 12- and 16-bit samples, 4 components, and the
  kinds cv2 refuses (signed, 6-bit, 5 components, subsampled); its SOP +
  EPH codestreams with the packet headers moved into PPT and PPM marker
  segments;
- JP2 boxes written here: palettes (pclr + cmap: 8- and 16-bit columns,
  short palettes, bad maps), channel definitions (cdef swaps and alpha),
  the colour spaces (sRGB, grey, sYCC, ICC, unknown, e-YCC, CMYK, none),
  an ihdr that disagrees with SIZ; EXIF boxes, which cv2 does not read;
- files cut short, which cv2 refuses.

Files cv2 returns None for raise ``ImageError`` naming the path and
"JPEG 2000".
"""

import ctypes
import io
import os
import struct
import tempfile

import cv2
import numpy as np
import pytest
from PIL import Image

from objectdetectionpl_tpu.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.parsers import common
from objectdetectionpl_tpu_torch.tools import format_files
from objectdetectionpl_tpu_torch.tools.fixture_trees import TESTDATA
from objectdetectionpl_tpu_torch.tools.format_files import jp2_box, jp2_bytes


def like_cv2(tmp_path, data: bytes, name="img", ext=".jp2"):
    """The port reads ``data`` as cv2 does under ``ext`` and a .jpg name;
    returns cv2's image, or None when both refuse it."""
    out = None
    for suffix in (ext, ".jpg"):
        path = tmp_path / f"{name}{suffix}"
        path.write_bytes(data)
        ref = load_image_rgb(str(path)) if cv2.imread(str(path)) is not None \
            else None
        if ref is None:
            for fn in (native.decode_image, common.load_image_rgb):
                with pytest.raises(native.ImageError,
                                   match=f"^{path}: JPEG 2000: "):
                    fn(str(path))
            continue
        for fn in (native.decode_image, common.load_image_rgb):
            got = fn(str(path))
            assert got.dtype == np.uint8 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref, err_msg=str(path))
        out = ref
    return out


def both_forms(tmp_path, codestream: bytes, enumcs=None, refused=False):
    """The codestream raw (.j2k) and in a JP2 file (grey for one or two
    components, sRGB otherwise, unless ``enumcs``): each read as cv2 reads
    it; with ``refused`` cv2 must refuse both."""
    n, w, h = _siz(codestream)
    if enumcs is None:
        enumcs = 17 if n < 3 else 16
    got = [like_cv2(tmp_path, codestream, "raw", ".j2k"),
           like_cv2(tmp_path, jp2_bytes(codestream, n, h, w, enumcs), "box")]
    if refused:
        assert got == [None, None]
    else:
        assert got[1] is not None
        assert n < 3 or got[0] is not None
    return got


def _siz(codestream: bytes):
    x1, y1, x0, y0 = struct.unpack(">IIII", codestream[8:24])
    return struct.unpack(">H", codestream[40:42])[0], x1 - x0, y1 - y0


@pytest.fixture(scope="module")
def photo():
    """A 70x90 crop of the VOC fixture, RGB int64."""
    bgr = cv2.imread(str(TESTDATA / "voc_420_q75_500x375.jpg"))
    return bgr[100:170, 200:290, ::-1].astype(np.int64)


def pillow(arr, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, "JPEG2000", **kw)
    return bio.getvalue()


# ---------------------------------------------------------------------------
# libopenjp2's encoder through ctypes (OpenJPEG 2.5's public structures:
# opj_cparameters_t, opj_image_t, opj_image_comp_t, opj_image_cmptparm_t)

_PRG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
_CPARAMS = 18720             # sizeof(opj_cparameters_t), 64-bit Linux
_OFF = dict(tile_size_on=0, cp_tdx=12, cp_tdy=16, cp_disto_alloc=20,
            csty=48, prog_order=52, poc=56, numpocs=4792, tcp_numlayers=4796,
            tcp_rates=4800, numresolution=5600, cblockw=5604, cblockh=5608,
            mode=5612, irreversible=5616, roi_compno=5620, roi_shift=5624,
            res_spec=5628, prcw=5632, prch=5764, dx=18196, tp_on=18696,
            tp_flag=18697, tcp_mct=18698)


@pytest.fixture(scope="module")
def opj():
    lib = ctypes.CDLL("libopenjp2.so.7")
    vp = ctypes.c_void_p
    for f in ("opj_create_compress", "opj_image_create",
              "opj_stream_create_default_file_stream"):
        getattr(lib, f).restype = vp
    lib.opj_version.restype = ctypes.c_char_p
    lib.opj_setup_encoder.argtypes = [vp, vp, vp]
    lib.opj_set_MCT.argtypes = [vp, vp, vp, ctypes.c_uint32]
    lib.opj_image_create.argtypes = [ctypes.c_uint32, vp, ctypes.c_int]
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p,
                                                          ctypes.c_int]
    lib.opj_start_compress.argtypes = [vp, vp, vp]
    lib.opj_encode.argtypes = lib.opj_end_compress.argtypes = [vp, vp]
    for f in ("opj_stream_destroy", "opj_destroy_codec",
              "opj_image_destroy"):
        getattr(lib, f).argtypes = [vp]
    # the layout this helper writes: the defaults where it expects them
    par = (ctypes.c_uint8 * _CPARAMS)()
    lib.opj_set_default_encoder_parameters(par)
    at = np.frombuffer(bytes(par), np.int32)
    assert lib.opj_version().startswith(b"2.5")
    assert [at[_OFF[k] // 4] for k in ("numresolution", "cblockw", "cblockh",
                                       "roi_compno", "dx")] == \
        [6, 64, 64, -1, 1]
    return lib


def opj_encode(lib, planes, prec=8, sgnd=0, sub=None, irreversible=False,
               mct=None, numres=6, cblk=(64, 64), mode=0, sop=False,
               eph=False, tile=None, tile_parts=None, rates=(0,),
               prog="LRCP", precincts=None, roi=None, pocs=(),
               mct_matrix=None, dc_shift=None) -> bytes:
    """Integer planes [h, w] -> a J2K codestream from libopenjp2; with
    ``mct_matrix`` (n x n) and ``dc_shift`` (n) through opj_set_MCT: the
    Part 2 array-based transform, written as CBD, MCT, MCC and MCO with
    the COD transform value 2."""
    planes = [np.asarray(p) for p in planes]
    n = len(planes)
    sub = sub or [(1, 1)] * n
    H, W = planes[0].shape[0] * sub[0][1], planes[0].shape[1] * sub[0][0]
    cp = (ctypes.c_uint32 * (9 * n))()
    for c in range(n):
        cp[9 * c:9 * c + 9] = [sub[c][0], sub[c][1], planes[c].shape[1],
                               planes[c].shape[0], 0, 0, prec, 0, sgnd]
    img = lib.opj_image_create(n, cp, 1 if n >= 3 else 2)
    ctypes.memmove(img, struct.pack("<IIII", 0, 0, W, H), 16)
    comps = ctypes.c_void_p.from_address(img + 24).value
    for c in range(n):
        data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
        np.ctypeslib.as_array((ctypes.c_int32 * planes[c].size).from_address(
            data))[:] = planes[c].reshape(-1)
    par = (ctypes.c_uint8 * _CPARAMS)()
    lib.opj_set_default_encoder_parameters(par)

    def put(key, v, extra=0):
        struct.pack_into("<i", par, _OFF[key] + extra, v)
    if tile:
        put("tile_size_on", 1)
        put("cp_tdx", tile[0])
        put("cp_tdy", tile[1])
    put("cp_disto_alloc", 1)
    put("csty", (2 if sop else 0) | (4 if eph else 0)
        | (1 if precincts else 0))
    put("prog_order", _PRG[prog])
    for i, (tileno, r0, c0, l1, r1, c1, order) in enumerate(pocs):
        struct.pack_into("<IIIII", par, _OFF["poc"] + 148 * i, r0, c0, l1, r1,
                         c1)
        put("poc", _PRG[order], 148 * i + 32)
        put("poc", tileno, 148 * i + 48)
    put("numpocs", len(pocs))
    put("tcp_numlayers", len(rates))
    for i, r in enumerate(rates):
        struct.pack_into("<f", par, _OFF["tcp_rates"] + 4 * i, r)
    put("numresolution", numres)
    put("cblockw", cblk[0])
    put("cblockh", cblk[1])
    put("mode", mode)
    put("irreversible", int(irreversible))
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    if precincts:
        put("res_spec", len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            put("prcw", pw, 4 * i)
            put("prch", ph, 4 * i)
    if tile_parts:
        par[_OFF["tp_on"]], par[_OFF["tp_flag"]] = 1, ord(tile_parts)
    par[_OFF["tcp_mct"]] = (1 if n >= 3 else 0) if mct is None else mct
    if mct_matrix is not None:
        m = np.ascontiguousarray(mct_matrix, np.float32)
        d = np.ascontiguousarray(dc_shift, np.int32)
        assert lib.opj_set_MCT(ctypes.addressof(par), m.ctypes.data,
                               d.ctypes.data, n)
    codec = lib.opj_create_compress(0)                  # OPJ_CODEC_J2K
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
    ok = (lib.opj_setup_encoder(codec, par, img)
          and lib.opj_start_compress(codec, img, stream)
          and lib.opj_encode(codec, stream)
          and lib.opj_end_compress(codec, stream))
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(img)
    with open(path, "rb") as f:
        data = f.read()
    os.unlink(path)
    assert ok, "libopenjp2 refused the parameters"
    return data


# ---------------------------------------------------------------------------
# cv2.imwrite

@pytest.mark.parametrize("rate", [None, 25, 250, 1000])
def test_cv2_imwrite(tmp_path, photo, rate):
    """cv2's writes: its default (lossy), compression rates x1000 and
    lossless; colour and grey, 8- and 16-bit."""
    params = [] if rate is None else [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
                                      rate]
    bgr = photo[..., ::-1]
    for img in (bgr.astype(np.uint8), bgr[..., 1].astype(np.uint8),
                (bgr * 257 + 100).astype(np.uint16),
                (bgr[..., 0] * 200).astype(np.uint16)):
        path = tmp_path / "w.jp2"
        assert cv2.imwrite(str(path), img, params)
        assert like_cv2(tmp_path, path.read_bytes()) is not None


# ---------------------------------------------------------------------------
# Pillow's encoder

PILLOW = {
    "5/3": dict(irreversible=False),
    "9/7": dict(irreversible=True),
    "9/7 layers": dict(irreversible=True, quality_mode="rates",
                       quality_layers=[60, 20, 5]),
    "MCT off 5/3": dict(irreversible=False, mct=0),
    "MCT off 9/7": dict(irreversible=True, mct=0),
    "tiles": dict(irreversible=True, tile_size=(32, 24),
                  quality_layers=[30, 8]),
    "cblk 16x8": dict(irreversible=False, codeblock_size=(16, 8)),
    "1 resolution": dict(irreversible=False, num_resolutions=1),
    "3 resolutions": dict(irreversible=True, num_resolutions=3),
    "precincts": dict(irreversible=True, precinct_size=(32, 32),
                      quality_layers=[40, 10]),
}


@pytest.mark.parametrize("name", list(PILLOW))
def test_pillow_options(tmp_path, photo, name):
    kw = PILLOW[name]
    rgb = photo.astype(np.uint8)
    for arr in (rgb, rgb[..., 0], np.dstack([rgb, rgb[..., 2]]),
                np.dstack([rgb[..., 1], rgb[..., 0]])):
        both_forms(tmp_path, pillow(arr, no_jp2=True, **kw))
        assert like_cv2(tmp_path, pillow(arr, **kw)) is not None


@pytest.mark.parametrize("prog", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
def test_progression_orders(tmp_path, photo, prog):
    """Each order over tiles clipped at the edges, precincts of two sizes
    and three quality layers, 5/3 and 9/7."""
    rgb = photo.astype(np.uint8)
    for irreversible in (False, True):
        both_forms(tmp_path, pillow(
            rgb, no_jp2=True, progression=prog, irreversible=irreversible,
            tile_size=(48, 40), precinct_size=(32, 32),
            codeblock_size=(16, 16),
            quality_layers=[40, 12, 3]))


def test_sixteen_bit_grey(tmp_path, photo):
    img = (photo[..., 1] * 251 + 7).astype(np.uint16)
    for irreversible in (False, True):
        both_forms(tmp_path, pillow(img, no_jp2=True,
                                    irreversible=irreversible))


# ---------------------------------------------------------------------------
# libopenjp2's encoder

STYLES = {"bypass": 1, "reset": 2, "termall": 4, "causal": 8, "pterm": 16,
          "segsym": 32, "all": 63, "bypass+termall": 5}


@pytest.mark.parametrize("name", list(STYLES))
def test_codeblock_styles(tmp_path, opj, photo, name):
    planes = [photo[..., i] for i in range(3)]
    for irreversible in (False, True):
        both_forms(tmp_path, opj_encode(
            opj, planes, mode=STYLES[name], irreversible=irreversible,
            rates=(50, 12, 1) if irreversible else (0,), cblk=(16, 16)))


MARKERS = {
    "SOP": dict(sop=True, rates=(20, 5, 1)),
    "EPH": dict(eph=True, rates=(20, 5, 1)),
    "SOP+EPH": dict(sop=True, eph=True, rates=(20, 5, 1), prog="RPCL",
                    precincts=[(32, 32), (64, 64)]),
    "tile-parts R": dict(tile=(32, 48), tile_parts="R", rates=(20, 5, 1)),
    "tile-parts L": dict(tile=(32, 48), tile_parts="L", rates=(20, 5, 1)),
    "tile-parts C": dict(tile=(32, 48), tile_parts="C", rates=(20, 5, 1),
                         sop=True),
    "ROI 5/3": dict(roi=(0, 5)),
    "ROI 9/7": dict(roi=(1, 3), irreversible=True, rates=(10,)),
    "POC": dict(pocs=[(1, 0, 0, 1, 3, 3, "RLCP"), (1, 0, 0, 3, 6, 3, "CPRL")],
                rates=(20, 5, 1)),
    "MCT off": dict(mct=0),
}


@pytest.mark.parametrize("name", list(MARKERS))
def test_markers(tmp_path, opj, photo, name):
    planes = [photo[..., i] for i in range(3)]
    both_forms(tmp_path, opj_encode(opj, planes, **MARKERS[name]))


def _split(cs: bytes):
    """A codestream -> (main header, [(tile-part markers, Isot, TPsot,
    TNsot, [(packet header + EPH, SOP + body), ...]), ...]); every packet
    must carry SOP and EPH, which delimit its header."""
    def marker_end(at):
        return at + 2 + struct.unpack(">H", cs[at + 2:at + 4])[0]
    at = 2
    while cs[at:at + 2] != b"\xff\x90":
        at = marker_end(at)
    main, parts = cs[:at], []
    while cs[at:at + 2] == b"\xff\x90":
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[at + 4:at + 12])
        sod = at + 12
        while cs[sod:sod + 2] != b"\xff\x93":
            sod = marker_end(sod)
        data, packets, p = cs[sod + 2:at + psot], [], 0
        while p < len(data):
            assert data[p:p + 2] == b"\xff\x91"
            eph = data.index(b"\xff\x92", p + 6)
            nxt = data.find(b"\xff\x91", eph + 2)
            nxt = len(data) if nxt < 0 else nxt
            packets.append((data[p + 6:eph + 2],
                            data[p:p + 6] + data[eph + 2:nxt]))
            p = nxt
        parts.append((cs[at + 12:sod], isot, tpsot, tnsot, packets))
        at += psot
    assert cs[at:] == b"\xff\xd9"
    return main, parts


def _segment(marker: bytes, body: bytes) -> bytes:
    return marker + struct.pack(">H", len(body) + 2) + body


def packed(cs: bytes, ppm: bool, restart_z: bool = False) -> bytes:
    """The codestream with its packet headers (and EPH markers) moved out
    of the tile data into PPT marker segments of each tile-part (numbered
    on across a tile's tile-parts, or from 0 in each with ``restart_z``),
    or with ``ppm`` into PPM segments of the main header (Nppm bytes a
    tile-part); SOP stays before each packet's body."""
    main, parts = _split(cs)
    out, stream, zppt = b"", b"", {}
    for markers, isot, tpsot, tnsot, packets in parts:
        heads = b"".join(h for h, _ in packets)
        body = b"".join(b for _, b in packets)
        if ppm:
            stream += struct.pack(">I", len(heads)) + heads
        else:
            z = 0 if restart_z else zppt.get(isot, 0)
            zppt[isot] = z + 1
            markers += _segment(b"\xff\x61", bytes([z]) + heads)
        out += (b"\xff\x90" + struct.pack(
            ">HHIBB", 10, isot, 14 + len(markers) + len(body), tpsot, tnsot)
            + markers + b"\xff\x93" + body)
    if ppm:
        main += _segment(b"\xff\x60", b"\x00" + stream)
    return main + out + b"\xff\xd9"


@pytest.mark.parametrize("ppm", [False, True])
def test_packed_packet_headers(tmp_path, opj, photo, ppm):
    """PPT and PPM: libopenjp2's SOP + EPH codestreams with their packet
    headers moved into the marker segments; a Zppt read twice in one tile
    fails in OpenJPEG and here."""
    planes = [photo[..., i] for i in range(3)]
    for kw in ({}, dict(tile=(32, 48), tile_parts="R", rates=(20, 5, 1)),
               dict(prog="RPCL", precincts=[(32, 32), (64, 64)],
                    rates=(20, 5, 1)),
               dict(irreversible=True, rates=(30, 10), mode=63)):
        cs = opj_encode(opj, planes, sop=True, eph=True, **kw)
        both_forms(tmp_path, packed(cs, ppm))
    if not ppm:
        both_forms(tmp_path, packed(opj_encode(
            opj, planes, sop=True, eph=True, tile=(32, 48), tile_parts="R",
            rates=(20, 5, 1)), False, restart_z=True), refused=True)


# ---------------------------------------------------------------------------
# marker segments as OpenJPEG's handlers check them: lengths, places,
# unknown markers, counts

def _main(cs: bytes, segment: bytes) -> bytes:
    """``segment`` at the end of the main header (before the first SOT)."""
    at = cs.index(b"\xff\x90")
    return cs[:at] + segment + cs[at:]


def _tile_parts(cs: bytes):
    at, out = cs.index(b"\xff\x90"), []
    while cs[at:at + 2] == b"\xff\x90":
        psot = struct.unpack(">I", cs[at + 6:at + 10])[0]
        out.append((at, psot))
        if not psot:                            # the last, to the end
            break
        at += psot
    return out


def _tile(cs: bytes, segment: bytes, k: int = 0) -> bytes:
    """``segment`` at the start of the k-th tile-part header, its Psot
    grown to match."""
    at, psot = _tile_parts(cs)[k]
    out = cs[:at + 12] + segment + cs[at + 12:]
    return out[:at + 6] + struct.pack(">I", psot + len(segment)) + \
        out[at + 10:]


def _raw(marker: int, length: int, body: bytes = b"") -> bytes:
    """A marker segment whose length field says ``length``."""
    return struct.pack(">HH", marker, length) + body


def _seg(marker: int, body: bytes) -> bytes:
    return _raw(marker, len(body) + 2, body)


def _main_segment(cs: bytes, marker: bytes) -> bytes:
    """The first ``marker`` segment of the main header."""
    at = 2
    while cs[at:at + 2] != marker:
        at += 2 + struct.unpack(">H", cs[at + 2:at + 4])[0]
    return cs[at:at + 2 + struct.unpack(">H", cs[at + 2:at + 4])[0]]


def _cblksty(cs: bytes, bits: int) -> bytes:
    """The main COD's code-block style with ``bits`` set."""
    cod = _main_segment(cs, b"\xff\x52")
    return cs.replace(cod, cod[:12] + bytes([cod[12] | bits]) + cod[13:])


def _poc(res1: int, prg: int = 0, res0: int = 0, comp0: int = 0,
         comp1: int = 3) -> bytes:
    return bytes([res0, comp0, 0, 1, res1, comp1, prg])


SEGMENTS = {   # name: codestream -> the codestream with that segment
    # PPM / PPT of no body or only their index: OpenJPEG wants both
    "PPM length 2": lambda cs: _main(cs, _raw(0xFF60, 2)),
    "PPM index only": lambda cs: _main(cs, _seg(0xFF60, b"\0")),
    "PPT length 2": lambda cs: _tile(cs, _raw(0xFF61, 2)),
    "PPT index only": lambda cs: _tile(cs, _seg(0xFF61, b"\0")),
    "PPT after PPM": lambda cs: _tile(_main(cs, _seg(0xFF60, bytes(5))),
                                      _seg(0xFF61, bytes(2))),
    # the quantisation and coding style markers fill their lengths exactly
    "QCC length 2": lambda cs: _main(cs, _raw(0xFF5D, 2)),
    "QCC component only": lambda cs: _main(cs, _seg(0xFF5D, b"\0")),
    "QCC no step sizes": lambda cs: _main(cs, _seg(0xFF5D, b"\0\x22")),
    "QCD length 2": lambda cs: _main(cs, _raw(0xFF5C, 2)),
    "QCD a byte too long": lambda cs: _main(
        cs, _seg(0xFF5C, b"\x21\x40\0\0")),
    "COD length 2": lambda cs: _main(cs, _raw(0xFF52, 2)),
    "COD short": lambda cs: _main(cs, _seg(0xFF52, b"\0\0\0\1\1\5")),
    "COD unknown Scod bit": lambda cs: cs.replace(
        _main_segment(cs, b"\xff\x52")[:5],
        _main_segment(cs, b"\xff\x52")[:4] + b"\x08"),
    "COD mixed HT style": lambda cs: _cblksty(cs, 0x80),
    "COD HT style": lambda cs: _cblksty(cs, 0x40),
    "COD twice": lambda cs: _main(cs, _main_segment(cs, b"\xff\x52")),
    "COD in a tile-part": lambda cs: _tile(cs,
                                           _main_segment(cs, b"\xff\x52")),
    "COC length 2": lambda cs: _main(cs, _raw(0xFF53, 2)),
    "COC short": lambda cs: _main(cs, _seg(0xFF53, b"\0\0\5\4\4")),
    "COC unknown Scoc bit": lambda cs: _main(
        cs, _seg(0xFF53, b"\0\x08\5\4\4\0\1")),
    "RGN length 2": lambda cs: _main(cs, _raw(0xFF5E, 2)),
    "RGN a byte too long": lambda cs: _main(cs, _seg(0xFF5E, bytes(4))),
    "RGN style 1": lambda cs: _main(cs, _seg(0xFF5E, b"\0\1\2")),
    "RGN in a tile-part": lambda cs: _tile(cs, _seg(0xFF5E, b"\0\0\1")),
    # POC: whole progressions only, fewer than 32 in all
    "POC length 2": lambda cs: _main(cs, _raw(0xFF5F, 2)),
    "POC a byte too long": lambda cs: _main(cs, _seg(0xFF5F,
                                                     _poc(6) + b"\0")),
    "POC 31": lambda cs: _main(cs, _seg(0xFF5F, _poc(6) * 31)),
    "POC 32": lambda cs: _main(cs, _seg(0xFF5F, _poc(6) * 32)),
    "POC 16 and 15": lambda cs: _main(cs, _seg(0xFF5F, _poc(6) * 16)
                                      + _seg(0xFF5F, _poc(6) * 15)),
    "POC 16 and 16": lambda cs: _main(cs, _seg(0xFF5F, _poc(6) * 16)
                                      + _seg(0xFF5F, _poc(6) * 16)),
    # pointer and informational markers: only their lengths are checked
    "TLM length 2": lambda cs: _main(cs, _raw(0xFF55, 2)),
    "TLM Ztlm only": lambda cs: _main(cs, _seg(0xFF55, b"\0")),
    "TLM ST 3": lambda cs: _main(cs, _seg(0xFF55, b"\0\x30")),
    "TLM odd entries": lambda cs: _main(cs, _seg(0xFF55, bytes(5))),
    "PLM length 2": lambda cs: _main(cs, _raw(0xFF57, 2)),
    "PLM Zplm only": lambda cs: _main(cs, _seg(0xFF57, b"\0")),
    "PLT length 2": lambda cs: _tile(cs, _raw(0xFF58, 2)),
    "PLT unfinished length": lambda cs: _tile(cs, _seg(0xFF58, b"\0\x81")),
    "PLT whole lengths": lambda cs: _tile(cs, _seg(0xFF58, b"\0\x81\1")),
    "CRG length 2": lambda cs: _main(cs, _raw(0xFF63, 2)),
    "CRG of each component": lambda cs: _main(cs, _seg(0xFF63, bytes(12))),
    "COM length 2": lambda cs: _main(cs, _raw(0xFF64, 2)),
    "COM odd": lambda cs: _main(cs, _seg(0xFF64, b"\0\1a")),
    "a length of 1": lambda cs: _main(cs, _raw(0xFF64, 1)),
    # markers out of their place
    "SIZ twice": lambda cs: _main(cs, _main_segment(cs, b"\xff\x51")),
    "PPT in the main header": lambda cs: _main(cs, _seg(0xFF61, bytes(2))),
    "PLT in the main header": lambda cs: _main(cs, _seg(0xFF58, b"\0\1")),
    "SOP in the main header": lambda cs: _main(cs, _seg(0xFF91, bytes(2))),
    "TLM in a tile-part": lambda cs: _tile(cs, _seg(0xFF55, bytes(2))),
    "PLM in a tile-part": lambda cs: _tile(cs, _seg(0xFF57, bytes(2))),
    "CRG in a tile-part": lambda cs: _tile(cs, _seg(0xFF63, bytes(12))),
    "SOT in a tile-part": lambda cs: _tile(
        cs, cs[cs.index(b"\xff\x90"):cs.index(b"\xff\x90") + 12]),
    "no COD": lambda cs: cs.replace(_main_segment(cs, b"\xff\x52"), b""),
    "no QCD": lambda cs: cs.replace(_main_segment(cs, b"\xff\x5c"), b""),
    # unknown markers: skipped two bytes at a time in the main header,
    # refused in a tile-part header
    "unknown, even length": lambda cs: _main(cs, _seg(0xFF70, bytes(4))),
    "unknown, odd length": lambda cs: _main(cs, _seg(0xFF70, bytes(3))),
    "unknown, length 1": lambda cs: _main(cs, _raw(0xFF70, 1)),
    "unknown holding a marker": lambda cs: _main(
        cs, _seg(0xFF70, b"\0\0\xff\x64\0\2")),
    "EPH in the main header": lambda cs: _main(cs, b"\xff\x92"),
    "EPH then COM": lambda cs: _main(cs, b"\xff\x92"
                                     + _seg(0xFF64, b"\0\1ab")),
    "unknown in a tile-part": lambda cs: _tile(cs, _seg(0xFF70, bytes(2))),
    # a quantisation style above 2 reads as expounded (2 bytes a band)
    "QCD style 3": lambda cs: cs.replace(
        _main_segment(cs, b"\xff\x5c")[:5],
        _main_segment(cs, b"\xff\x5c")[:4]
        + bytes([_main_segment(cs, b"\xff\x5c")[4] | 3])),
}


@pytest.fixture(scope="module")
def small():
    """A 24x32 RGB codestream, 5/3 and 9/7."""
    rgb = np.random.RandomState(0).randint(0, 256, (24, 32, 3)).astype(
        np.uint8)
    return {False: pillow(rgb, no_jp2=True),
            True: pillow(rgb, no_jp2=True, irreversible=True,
                         quality_mode="rates", quality_layers=[20])}


# the cases cv2 reads on this build (the rest it refuses), so that they
# do not all pass by refusal; "QCD style 3" only on the 9/7 file, whose
# step sizes are two bytes a band
SEGMENTS_READ = {
    "QCC no step sizes", "COD twice", "COD in a tile-part",
    "COC unknown Scoc bit", "RGN style 1", "RGN in a tile-part", "POC 31",
    "POC 16 and 15", "TLM ST 3", "TLM odd entries", "PLM Zplm only",
    "PLT whole lengths", "CRG of each component", "COM length 2", "COM odd",
    "unknown, even length", "unknown, length 1", "unknown holding a marker",
    "EPH in the main header", "EPH then COM"}


# HT code-blocks, which the port refuses naming HTJ2K: cv2 refuses the 5/3
# file with the HT bit set too, and reads the 9/7 one as noise (a known
# difference, ROADMAP §C), so that case holds the 5/3 file only
ONLY_53 = {"COD HT style"}


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_marker_segments(tmp_path, small, name):
    """Each on the 5/3 and the 9/7 file as cv2 reads it (``like_cv2``:
    equal images, or ImageError naming JPEG 2000 where cv2 refuses), with
    cv2's outcome; none is read past its segment or the file."""
    for irreversible, cs in small.items():
        if irreversible and name in ONLY_53:
            continue
        got = like_cv2(tmp_path, SEGMENTS[name](cs), "raw", ".j2k")
        reads = name in SEGMENTS_READ or (name == "QCD style 3"
                                          and irreversible)
        assert (got is not None) == reads


# ---------------------------------------------------------------------------
# Part 2's multiple component transformation (MCT, MCC, MCO, CBD) and Part
# 15's capability markers (CAP, CPF) as OpenJPEG 2.5 reads them: an MCO
# stage sets the components' DC level shifts from its collection's offset
# array (none: 0); the decorrelation array is sized but never applied, as
# its COD refuses the transform value 2 that asks for it; CBD replaces
# SIZ's bit depths; CAP and CPF are skipped

def _mct(index: int, array: int, elem: int, data: bytes, zmct: int = 0,
         ymct: int = 0) -> bytes:
    """An MCT segment: Imct from its index, array type (1 decorrelation, 2
    offset) and element type (int16, int32, float32, float64)."""
    return _seg(0xFF74, struct.pack(">HHH", zmct,
                                    index | array << 8 | elem << 10, ymct)
                + data)


def _mcc(index: int, n: int, deco: int, offset: int, zmcc: int = 0,
         ymcc: int = 0, qmcc: int = 1, xmcc: int = 1, comps=None,
         wcomps=None) -> bytes:
    """An MCC segment of one collection over ``comps`` (default 0..n-1)
    to ``wcomps``, naming the MCT indices ``deco`` and ``offset``."""
    comps = list(range(n)) if comps is None else comps
    wcomps = list(range(n)) if wcomps is None else wcomps
    body = struct.pack(">HBHH", zmcc, index, ymcc, qmcc)
    if qmcc:
        body += struct.pack(">BH", xmcc, len(comps)) + bytes(comps) + \
            struct.pack(">H", len(wcomps)) + bytes(wcomps) + \
            bytes([0, offset, deco])
    return _seg(0xFF75, body)


def _mco(*stages: int) -> bytes:
    return _seg(0xFF77, bytes([len(stages), *stages]))


def _cbd(depths) -> bytes:
    return _seg(0xFF78, struct.pack(">H", len(depths)) + bytes(depths))


_ELEM = {0: ">H", 1: ">i", 2: ">f", 3: ">d"}


def _values(elem: int, values) -> bytes:
    return b"".join(struct.pack(_ELEM[elem], v) for v in values)


def _offsets(cs: bytes, elem: int, values, where=_main) -> bytes:
    """``values`` as DC level shifts: an offset array, its collection and
    one MCO stage."""
    return where(cs, _mct(1, 2, elem, _values(elem, values))
                 + _mcc(1, 3, 0, 1) + _mco(1))


_SHIFTS = _mct(1, 2, 0, _values(0, [10, 20, 30]))
_SHIFTS2 = _mct(2, 2, 0, _values(0, [50, 60, 70]))
PART2 = {  # name: (codestream -> codestream, cv2 reads it)
    # the offsets in each element type: int16 as unsigned, int32 as
    # signed, floats truncated, out of range as x86's integer indefinite
    **{f"offsets {t} {k}": ((lambda cs, e=e, v=v: _offsets(cs, e, v)), True)
       for e, t in enumerate(("int16", "int32", "float32", "float64"))
       for k, v in {"small": [10, 20, 30], "zero": [0, 0, 0],
                    "large": [200, 65535, 7]}.items()},
    "offsets int32 negative": (lambda cs: _offsets(cs, 1, [-5, 300, -70000]),
                               True),
    **{f"offsets {t} fractions": (
        (lambda cs, e=e: _offsets(cs, e, [-5.7, 128.9, 1e12])), True)
       for e, t in ((2, "float32"), (3, "float64"))},
    **{f"offsets {t} NaN": (
        (lambda cs, e=e: _offsets(cs, e, [float("nan"), -1e30, 3e9])), True)
       for e, t in ((2, "float32"), (3, "float64"))},
    # a decorrelation array of each type is sized, not applied
    **{f"decorrelation {t}": ((lambda cs, e=e: _main(
        cs, _mct(2, 1, e, _values(e, [1, 3, 0, 0, 1, 0, 0, 0, 1]))
        + _mct(1, 2, 0, _values(0, [100, 120, 140])) + _mcc(1, 3, 2, 1)
        + _mco(1))), True)
       for e, t in enumerate(("int16", "int32", "float32", "float64"))},
    **{f"decorrelation {t} short": ((lambda cs, e=e: _main(
        cs, _mct(2, 1, e, _values(e, [1] * 8)) + _mcc(1, 3, 2, 0)
        + _mco(1))), False)
       for e, t in enumerate(("int16", "int32", "float32", "float64"))},
    "offsets short": (lambda cs: _main(cs, _mct(1, 2, 1, _values(1, [1, 2]))
                                       + _mcc(1, 3, 0, 1) + _mco(1)), False),
    # MCO: zero stages zero the shifts; more than one is not taken
    "MCO zero stages": (lambda cs: _main(cs, _mco()), True),
    "MCO two stages": (lambda cs: _main(cs, _SHIFTS + _mcc(1, 3, 0, 1)
                                        + _mco(1, 1)), True),
    "MCO naming no MCC": (lambda cs: _main(cs, _mco(1)), True),
    "MCO without its index": (lambda cs: _main(cs, _seg(0xFF77, b"\1")),
                              False),
    "MCO overlong": (lambda cs: _main(cs, _seg(0xFF77, b"\0\5")), False),
    "MCO empty": (lambda cs: _main(cs, _seg(0xFF77, b"")), False),
    "MCO then MCO zero stages": (lambda cs: _main(
        cs, _SHIFTS + _mcc(1, 3, 0, 1) + _mco(1) + _mco()), True),
    "offsets without MCO": (lambda cs: _main(cs, _SHIFTS + _mcc(1, 3, 0, 1)),
                            True),
    # OpenJPEG compares an MCO stage with its first collection only
    "two MCCs, the second named": (lambda cs: _main(
        cs, _SHIFTS + _SHIFTS2 + _mcc(1, 3, 0, 1) + _mcc(2, 3, 0, 2)
        + _mco(2)), True),
    "two MCCs, the first named": (lambda cs: _main(
        cs, _SHIFTS + _SHIFTS2 + _mcc(1, 3, 0, 1) + _mcc(2, 3, 0, 2)
        + _mco(1)), True),
    # MCT: a later array of an index replaces it; Zmct and Ymct
    "MCT replaced": (lambda cs: _main(
        cs, _SHIFTS + _mct(1, 2, 0, _values(0, [90, 91, 92]))
        + _mcc(1, 3, 0, 1) + _mco(1)), True),
    "MCT replaced after its MCC": (lambda cs: _main(
        cs, _SHIFTS + _mcc(1, 3, 0, 1)
        + _mct(1, 2, 0, _values(0, [90, 91, 92])) + _mco(1)), True),
    "MCT Ymct 1 drops the array": (lambda cs: _main(
        cs, _SHIFTS + _mct(1, 2, 0, _values(0, [90, 91, 92]), ymct=1)
        + _mcc(1, 3, 0, 1) + _mco(1)), False),
    "MCC naming an MCT Zmct 1 left out": (lambda cs: _main(
        cs, _mct(1, 2, 0, _values(0, [90, 91, 92]), zmct=1)
        + _mcc(1, 3, 0, 1) + _mco(1)), False),
    "MCC naming a missing MCT": (lambda cs: _main(
        cs, _SHIFTS + _mcc(1, 3, 0, 2) + _mco(1)), False),
    "MCT of 6 bytes": (lambda cs: _main(cs, _seg(0xFF74, bytes(6))), False),
    "MCT of 1 byte": (lambda cs: _main(cs, _seg(0xFF74, b"\0")), False),
    # MCC forms OpenJPEG does not take
    **{f"MCC {k}": ((lambda cs, kw=kw: _main(
        cs, _SHIFTS + _mcc(1, 3, 0, 1, **kw) + _mco(1))), True)
       for k, kw in {"Zmcc 1": dict(zmcc=1), "Ymcc 1": dict(ymcc=1),
                     "Xmcc 0": dict(xmcc=0), "Qmcc 0": dict(qmcc=0),
                     "components shuffled": dict(comps=[0, 2, 1]),
                     "W count differs": dict(wcomps=[0, 1])}.items()},
    "MCC over 2 components": (lambda cs: _main(
        cs, _SHIFTS + _mcc(1, 2, 0, 1, comps=[0, 1], wcomps=[0, 1]) + _mco(1)),
        True),
    "MCC overlong": (lambda cs: _main(
        cs, _SHIFTS + _seg(0xFF75, _mcc(1, 3, 0, 1)[4:] + b"\0") + _mco(1)),
        False),
    # in a tile-part header
    "offsets in a tile-part": (lambda cs: _offsets(cs, 0, [10, 20, 30],
                                                   _tile), True),
    "MCO zero stages in a tile-part": (lambda cs: _tile(
        _main(cs, _SHIFTS + _mcc(1, 3, 0, 1) + _mco(1)), _mco()), True),
    # CBD: SIZ's bit depths replaced (the DC level shift stays SIZ's)
    "CBD 8 bits": (lambda cs: _main(cs, _cbd([7, 7, 7])), True),
    "CBD 10 bits": (lambda cs: _main(cs, _cbd([9, 9, 9])), True),
    "CBD 8 10 8 bits": (lambda cs: _main(cs, _cbd([7, 9, 7])), True),
    "CBD 16 bits": (lambda cs: _main(cs, _cbd([15, 15, 15])), True),
    "CBD 6 bits": (lambda cs: _main(cs, _cbd([5, 5, 5])), False),
    "CBD signed": (lambda cs: _main(cs, _cbd([0x87] * 3)), False),
    "CBD 41 bits": (lambda cs: _main(cs, _cbd([40, 7, 7])), False),
    "CBD short": (lambda cs: _main(cs, _cbd([7, 7])), False),
    "CBD Ncbd 2": (lambda cs: _main(cs, _seg(0xFF78, b"\0\2\7\7\7")),
                   False),
    "CBD in a tile-part": (lambda cs: _tile(cs, _cbd([7, 7, 7])), False),
    # CAP and CPF (Part 15) on a codestream of MQ-coded code-blocks
    "CAP empty": (lambda cs: _main(cs, _seg(0xFF50, b"")), True),
    "CAP with Part 15": (lambda cs: _main(
        cs, _seg(0xFF50, struct.pack(">IH", 1 << 14, 3))), True),
    "CPF": (lambda cs: _main(cs, _seg(0xFF59, b"\0\0")), True),
    "CAP in a tile-part": (lambda cs: _tile(cs, _seg(0xFF50, bytes(4))),
                           False),
}


@pytest.mark.parametrize("name", list(PART2))
def test_part2_marker_segments(tmp_path, small, name):
    """Each hand-edited case on the 5/3 and the 9/7 file as cv2 reads it,
    with cv2's outcome."""
    edit, reads = PART2[name]
    for cs in small.values():
        got = like_cv2(tmp_path, edit(cs), "raw", ".j2k")
        assert (got is not None) == reads


_ICT = [[0.299, 0.587, 0.114], [-0.16875, -0.33126, 0.5],
        [0.5, -0.41869, -0.08131]]


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("matrix", ["identity", "ICT", "seeded"])
def test_part2_from_opj_set_mct(tmp_path, opj, photo, n, matrix):
    """libopenjp2's Part 2 writes (opj_set_MCT: CBD, an MCT decorrelation
    array of float32 and an offset array of int32, MCC, MCO) with seeded
    DC shifts, 5/3 and 9/7: refused as written (COD's transform value 2),
    as cv2 refuses them; with that value set to 0 or 1, read as cv2 reads
    them (the offsets as shifts, the array unused)."""
    rng = np.random.RandomState(n * 7 + len(matrix))
    planes = [photo[..., c] for c in range(3)] + \
        [photo[..., 1] // 2 + 40] * (n - 3)
    m = {"identity": np.eye(n),
         "ICT": np.pad(_ICT, (0, n - 3)) + np.diag([0] * 3 + [1] * (n - 3)),
         "seeded": np.eye(n) + rng.uniform(-.3, .3, (n, n))}[matrix]
    for irreversible in (False, True):
        cs = opj_encode(opj, planes, irreversible=irreversible, mct_matrix=m,
                        dc_shift=rng.randint(-50, 200, n))
        cod = _main_segment(cs, b"\xff\x52")
        assert cod[8] == 2 and b"\xff\x75" in cs and b"\xff\x77" in cs
        both_forms(tmp_path, cs, refused=True)
        for value in (0, 1):
            both_forms(tmp_path, cs.replace(
                cod, cod[:8] + bytes([value]) + cod[9:]))


def test_committed_part2_fixture(opj):
    """``data/testdata/formats/j2k_part2_mct_160x120.j2k`` is libopenjp2's
    9/7 write of the 160x120 crop ``rgb[100:220, 150:310]`` of the 500x375
    fixture through opj_set_MCT (the ICT's matrix, DC shifts 128, 120,
    136), its COD transform value set to 1."""
    rgb = native.decode_one(str(TESTDATA / format_files.BASE))
    crop = rgb[100:220, 150:310].astype(np.int64)
    cs = opj_encode(opj, [crop[..., c] for c in range(3)], irreversible=True,
                    mct_matrix=_ICT, dc_shift=[128, 120, 136])
    cod = _main_segment(cs, b"\xff\x52")
    cs = cs.replace(cod, cod[:8] + b"\1" + cod[9:])
    assert cs == format_files.COMMITTED["j2k_part2"].read_bytes()


def _sot(cs: bytes, k: int, offset: int, fmt: str, value: int) -> bytes:
    """The k-th tile-part's SOT field at ``offset`` set to ``value``."""
    at = _tile_parts(cs)[k][0] + offset
    return cs[:at] + struct.pack(fmt, value) + cs[at + struct.calcsize(fmt):]


def _all_tnsot_0(cs: bytes) -> bytes:
    for k in range(len(_tile_parts(cs))):
        cs = _sot(cs, k, 11, ">B", 0)
    return cs


TILE_PARTS = {  # name: (four tiles of one part -> codestream, cv2 reads)
    "TPsot 1 first": (lambda cs: _sot(cs, 0, 10, ">B", 1), False),
    "TPsot past TNsot": (lambda cs: _sot(_sot(cs, 0, 10, ">B", 1), 0, 11,
                                         ">B", 1), False),
    "Psot 12": (lambda cs: _sot(cs, 1, 6, ">I", 12), False),
    "Psot 13": (lambda cs: _sot(cs, 1, 6, ">I", 13), False),
    "TNsot 0": (_all_tnsot_0, True),
    "TNsot 2, one part": (lambda cs: _sot(cs, 0, 11, ">B", 2), True),
    # OpenJPEG reads no further once every tile has its last part
    "2 bytes for the EOC": (lambda cs: cs[:-2] + b"\x12\x34", True),
    "4 bytes for the EOC": (lambda cs: cs[:-2] + b"\x12\x34\x56\x78", False),
    "a cut SOT for the EOC": (lambda cs: cs[:-2] + b"\xff\x90\0\x0a\0\x09",
                              True),
    "no EOC": (lambda cs: cs[:-2], False),
    "TNsot 0, 4 bytes for the EOC": (
        lambda cs: _all_tnsot_0(cs)[:-2] + b"\x12\x34\x56\x78", False),
    # a last Psot of 0 runs to the file's last two bytes, whatever they are
    "last Psot 0": (lambda cs: _sot(cs, 3, 6, ">I", 0), True),
    "last Psot 0, no EOC": (lambda cs: _sot(cs, 3, 6, ">I", 0)[:-2]
                            + b"\0\0", True),
    "last Psot 0 of a tile without TNsot, no EOC": (
        lambda cs: _sot(_sot(cs, 3, 6, ">I", 0), 3, 11, ">B", 0)[:-2]
        + b"\0\0", True),
}


@pytest.mark.parametrize("name", list(TILE_PARTS))
def test_tile_parts(tmp_path, name):
    """SOT's rules (TPsot in order from 0 and within TNsot, Psot 0 or at
    least 14) and where OpenJPEG stops reading, on four tiles of one
    tile-part each."""
    rgb = np.random.RandomState(2).randint(0, 256, (40, 64, 3)).astype(
        np.uint8)
    cs = pillow(rgb, no_jp2=True, tile_size=(32, 24), num_resolutions=3)
    assert [cs[at + 11] for at, _ in _tile_parts(cs)] == [1] * 4   # TNsot
    change, reads = TILE_PARTS[name]
    assert (like_cv2(tmp_path, change(cs), "raw", ".j2k") is not None) == \
        reads


def test_sop_and_eph_markers_missing(tmp_path, opj, photo):
    """A missing SOP marker is passed over; a missing EPH marker where
    two bytes remain fails, as in OpenJPEG."""
    planes = [photo[..., i] for i in range(3)]
    cs = opj_encode(opj, planes, sop=True, eph=True, rates=(20, 5, 1))
    (_, psot), = _tile_parts(cs)
    sod = cs.index(b"\xff\x93") + 2

    def drop(at: int, n: int) -> bytes:
        return _sot(cs[:at] + cs[at + n:], 0, 6, ">I", psot - n)

    assert like_cv2(tmp_path, drop(cs.index(b"\xff\x91", sod + 6), 6), "raw",
                    ".j2k") is not None
    assert like_cv2(tmp_path, drop(cs.index(b"\xff\x92", sod), 2), "raw",
                    ".j2k") is None


def test_resolutions_reached(tmp_path):
    """A tile's component is rebuilt up to the highest resolution one of
    its packets reached, at the top left of the tile, and copied to the
    image at that resolution's coordinates (the rest stays 0), as
    OpenJPEG does: POCs that stop short, in the main header and in one
    tile-part of two; progression orders past CPRL, which make no
    packets; one component short of the others."""
    rgb = np.random.RandomState(1).randint(0, 256, (40, 64, 3)).astype(
        np.uint8)
    one = pillow(rgb, no_jp2=True, num_resolutions=4)
    two = pillow(rgb, no_jp2=True, num_resolutions=4, tile_size=(32, 40))
    short = []
    for cs in (_main(one, _seg(0xFF5F, _poc(3))),
               _main(one, _seg(0xFF5F, _poc(1))),
               _main(one, _seg(0xFF5F, _poc(6, prg=5))),
               _main(one, _seg(0xFF5F, _poc(6, prg=7))),
               _main(one, _seg(0xFF5F, _poc(2, comp1=1)
                               + _poc(4, comp0=1))),
               _main(two, _seg(0xFF5F, _poc(2))),
               _tile(two, _seg(0xFF5F, _poc(2)), 0),
               _tile(two, _seg(0xFF5F, _poc(2)), 1)):
        got = like_cv2(tmp_path, cs, "raw", ".j2k")
        short.append(int((got == 0).all(-1).sum()))
    assert all(short[:4]) and short[6] and short[7]


def test_precision_and_components(tmp_path, opj, photo):
    """12- and 16-bit samples shift right to 8 bits; 4 components drop
    the fourth; cv2 refuses signed samples, 6 bits, 5 components and
    subsampled ones."""
    planes = [photo[..., i] for i in range(3)]
    both_forms(tmp_path, opj_encode(opj, [p * 16 + 7 for p in planes],
                                    prec=12))
    both_forms(tmp_path, opj_encode(opj, [p * 257 for p in planes], prec=16,
                                    irreversible=True, rates=(20,)))
    both_forms(tmp_path, opj_encode(opj, [planes[0] * 16], prec=12))
    both_forms(tmp_path, opj_encode(opj, planes + [planes[0]]))
    both_forms(tmp_path, opj_encode(opj, [p >> 2 for p in planes], prec=6),
               refused=True)
    both_forms(tmp_path, opj_encode(opj, [p - 128 for p in planes], sgnd=1),
               refused=True)
    both_forms(tmp_path, opj_encode(opj, planes + planes[:2]), refused=True)
    both_forms(tmp_path, opj_encode(
        opj, [planes[0], planes[1][::2, ::2], planes[2][::2, ::2]],
        sub=[(1, 1), (2, 2), (2, 2)]), refused=True)


# ---------------------------------------------------------------------------
# JP2 boxes

def test_palettes(tmp_path, photo):
    rng = np.random.RandomState(3)
    index = photo[..., 1].astype(np.uint8)
    h, w = index.shape
    cs = pillow(index, no_jp2=True)
    direct = [(0, 1, i) for i in range(3)]
    cases = [  # (bits, entries, cmap, cv2 reads it)
        ([8, 8, 8], rng.randint(0, 256, (256, 3)), direct, True),
        ([16, 12, 8], rng.randint(0, 256, (256, 3)) * [257, 16, 1], direct,
         True),
        ([8, 8, 8], rng.randint(0, 256, (100, 3)), direct, True),  # clamped
        ([8, 8, 8, 8], rng.randint(0, 256, (256, 4)),
         direct + [(0, 1, 3)], True),
        ([8, 8, 8], rng.randint(0, 256, (256, 3)), [(0, 1, 0)] * 3, False),
        ([8, 8, 8], rng.randint(0, 256, (256, 3)), [(1, 1, i) for i in
                                                    range(3)], False),
    ]
    for bits, entries, cmap, reads in cases:
        got = like_cv2(tmp_path, jp2_bytes(cs, 1, h, w, pclr=(bits, entries),
                                           cmap=cmap))
        assert (got is not None) == reads
    # a palette without cmap is not applied: one channel read as sRGB
    assert like_cv2(tmp_path, jp2_bytes(
        cs, 1, h, w, pclr=([8, 8, 8], np.zeros((4, 3))))) is None


def test_channel_definitions(tmp_path, photo):
    rgb = photo.astype(np.uint8)
    h, w = rgb.shape[:2]
    cs3 = pillow(rgb, no_jp2=True)
    cs4 = pillow(np.dstack([rgb, rgb[..., 0]]), no_jp2=True)
    for cdef, reads in (([(0, 0, 3), (1, 0, 2), (2, 0, 1)], True),
                        ([(0, 1, 0), (1, 0, 1), (2, 0, 2)], True),
                        ([(0, 0, 2), (1, 0, 3), (2, 0, 1)], True),
                        ([(2, 0, 1), (1, 0, 2), (0, 0, 3)], True),
                        ([(0, 0, 65535), (1, 0, 2), (2, 0, 3)], True),
                        ([(0, 0, 1), (1, 0, 2)], False),         # incomplete
                        ([(0, 0, 1), (1, 0, 2), (3, 0, 3)], False)):
        got = like_cv2(tmp_path, jp2_bytes(cs3, 3, h, w, cdef=cdef))
        assert (got is not None) == reads
    got = like_cv2(tmp_path, jp2_bytes(cs4, 4, h, w, cdef=[
        (0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]))
    assert got is not None


def test_colour_spaces(tmp_path, photo):
    """sRGB, grey (the first component repeated), sYCC (cv2's integer
    YUV-to-BGR), an ICC profile, an unknown space and none (read as
    sRGB); e-YCC and CMYK are refused, as is an ihdr of another size."""
    rgb = photo.astype(np.uint8)
    h, w = rgb.shape[:2]
    cs = pillow(rgb, no_jp2=True, mct=0)
    for enumcs, colr, reads in ((16, None, True), (17, None, True),
                                (18, None, True), (99, None, True),
                                (None, b"\x02\x00\x00" + bytes(64), True),
                                (None, b"\x03\x00\x00" + bytes(8), True),
                                (None, None, True), (24, None, False),
                                (12, None, False)):
        got = like_cv2(tmp_path, jp2_bytes(cs, 3, h, w, enumcs=enumcs,
                                           colr=colr))
        assert (got is not None) == reads, (enumcs, colr)
    grey = pillow(rgb[..., 0], no_jp2=True)
    assert like_cv2(tmp_path, jp2_bytes(grey, 1, h, w, enumcs=18)) is None
    assert like_cv2(tmp_path, jp2_bytes(cs, 3, h + 1, w)) is None


def test_codestream_box_lengths(tmp_path, photo):
    """OpenJPEG reads the codestream from the jp2c box's header to the
    end of the file whatever the box's length says (0, 2, 8, past the
    end, a 64-bit one); a box before it must fit the file."""
    base = pillow(photo.astype(np.uint8))
    at = base.index(b"jp2c") - 4

    def length(n: int, xl: bytes = b"") -> bytes:
        return base[:at] + struct.pack(">I", n) + b"jp2c" + xl + base[at + 8:]

    for data in (length(0), length(2), length(8), length(0xFFFFFF00),
                 length(1, struct.pack(">Q", 100)),
                 length(1, struct.pack(">Q", 1 << 32)),
                 base + b"\0\0\0\5after",
                 base[:at] + struct.pack(">I", 9) + b"abcdz" + base[at:]):
        assert like_cv2(tmp_path, data) is not None
    for data in (base[:at] + struct.pack(">I", 0) + b"abcd" + base[at:],
                 base[:at] + struct.pack(">I", 7) + b"abcd" + base[at:]):
        assert like_cv2(tmp_path, data) is None


def test_exif_boxes_turn_nothing(tmp_path, photo):
    """An EXIF block with Orientation 6 in a JP2 file (the "JpgTiffExif->JP2"
    uuid box, with and without its Exif header, and an Exif box): cv2's
    JPEG 2000 decoder reads no EXIF, so the image stays unturned."""
    rgb = photo.astype(np.uint8)
    h, w = rgb.shape[:2]
    base = jp2_bytes(pillow(rgb, no_jp2=True), 3, h, w)
    at = base.find(b"jp2c") - 4
    tiff = (b"II*\0" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHIHH", 0x112, 3, 1, 6, 0) + bytes(4))
    uuid = b"JpgTiffExif->JP2"
    for box in (jp2_box(b"uuid", uuid + b"Exif\0\0" + tiff),
                jp2_box(b"uuid", uuid + tiff), jp2_box(b"Exif", tiff)):
        got = like_cv2(tmp_path, base[:at] + box + base[at:])
        assert got.shape == (h, w, 3)


def test_cut_files_are_refused(tmp_path, photo):
    rgb = photo.astype(np.uint8)
    for data in (pillow(rgb), pillow(rgb, no_jp2=True, tile_size=(32, 32))):
        for cut in (20, 60, len(data) // 3, len(data) - 40, len(data) - 2):
            like_cv2(tmp_path, data[:cut])
        assert like_cv2(tmp_path, data) is not None
