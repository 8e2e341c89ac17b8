"""ctypes binding of the port's host library: the resize, the JPEG
decoder, the JPEG 2000 codestream decoder, the AV1 decoder, GIF's LZW and
the inner loops of the PNG, WebP and TIFF readers, one ``.so``.

``csrc/preproc.cc`` resizes uint8 RGB images into a batch [N, S, S, 3],
two kinds picked per call: float32 in [0, 1] (a copy of the JAX package's
``native/preproc.cc`` resize, so batches equal its bit for bit) and uint8
(cv2's INTER_LINEAR, bit for bit: what the JAX package fills its packed
cache with).  ``csrc/jpeg_decode.cc`` is the port's own JPEG
decoder, sequential and progressive, at 1/1, 1/2, 1/4 or 1/8 scale (equal
bit for bit to libjpeg-turbo's decompression to RGB with that
``scale_denom``).  ``csrc/png_decode.cc``, ``csrc/webp_decode.cc``,
``csrc/tiff_decode.cc``, ``csrc/jp2_decode.cc``, ``csrc/gif_decode.cc``
and ``csrc/av1_decode.cc`` (with its tables, ``csrc/av1_tables.h``)
serve :func:`decode_image`'s readers.  All build
with g++ into ``build/native/libpreproc-<key>.so`` at the repository
root.

- :func:`preproc_batch`: decoded images -> the batch, one call;
- :func:`decode_preproc_batch`: JPEG files -> the batch, one call, each
  worker thread reading and decoding a file into buffers it reuses and
  resizing it straight into its slot; with ``max_denom`` above 1 at the
  DCT scale the JAX package's fused loader picks (the Loader's float32
  batches), at full scale otherwise (the uint8 cache);
- :func:`decode_batch`: JPEG files -> decoded images, one call, each file
  read once by the thread that decodes it, at full scale unless
  ``denom`` says otherwise; :func:`decode_one` is a batch of one.

With ``exif`` the decode and the fused call turn each image by the EXIF
Orientation tag of its file, as ``cv2.imread`` does (the decoder reads the
tag as OpenCV does, and a malformed one turns nothing, as there): the JAX
package reads images with ``cv2.imread`` for its parsers, its predict CLI
and its packed cache, but not in its fused float32 loader.

The batch functions write into ``out`` when the caller passes one (a
pinned buffer it reuses, a cache's rows), else into a new array.  A file
the decoder cannot read raises :class:`JpegError` naming the path and the
reason, once the other files of the call are done; there is no other
decoder to fall back to.  Without g++ the build fails, :func:`available`
is False, ``build_error`` says why, the Loader resizes with torch
(``pipeline.torch_resize``) and the real datasets raise.

The key hashes the sources, the flags and the host's name:
``-march=native`` code belongs to the machine that built it.  A build
runs on first use, under a file lock, into a temporary file that is
renamed into place.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import weakref
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CSRC = REPO / "objectdetectionpl_tpu_torch" / "csrc"
SOURCES = (CSRC / "preproc.cc", CSRC / "jpeg_decode.cc",
           CSRC / "png_decode.cc", CSRC / "webp_decode.cc",
           CSRC / "tiff_decode.cc", CSRC / "jp2_decode.cc",
           CSRC / "gif_decode.cc", CSRC / "av1_decode.cc")
HEADERS = (CSRC / "jpeg_decode.h", CSRC / "av1_tables.h")
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread", "-Wall")
BUILD_TIMEOUT_S = 300
JPEG_OK = 0              # csrc/jpeg_decode.h's codes; any other is an error
MSG_LEN = 256
DENOMS = (1, 2, 4, 8)    # the DCT scales: libjpeg's scale_denom
MAX_DENOM = 8            # the float32 Loader's, as the JAX package's

_lib = None
_load_failed = False
build_error: Optional[str] = None   # why the library is unavailable


READ_EXIF, READ_IMREAD = 1, 2   # csrc/jpeg_decode.h's Flags


class ImageError(OSError):
    """An image file the port cannot read: the message names the path (an
    OSError, as the JAX package's ``IOError("cannot read image ...")``)."""


class JpegError(ImageError):
    """A JPEG file the decoder cannot read: the message names the path."""


def _flags(exif: bool, imread: bool) -> int:
    return (READ_EXIF if exif else 0) | (READ_IMREAD if imread else 0)


def library_path() -> Path:
    digest = hashlib.sha256()
    for f in SOURCES + HEADERS:
        digest.update(f.name.encode() + f.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode() + platform.node().encode())
    return BUILD_DIR / f"libpreproc-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists.  Raises OSError (no compiler)
    or SubprocessError (a failed build)."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # one build at once
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS,
                            *map(str, SOURCES), "-o", str(tmp)], check=True,
                           capture_output=True, timeout=BUILD_TIMEOUT_S)
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return lib


def _why(e: Exception) -> str:
    stderr = getattr(e, "stderr", None) or b""
    return f"{type(e).__name__}: {e} {stderr.decode()[-400:]}"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, build_error
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError) as e:
        _load_failed = True
        build_error = _why(e)
        return None
    i32p, f32p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    lib.preproc_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),                 # srcs
        i32p, i32p, ctypes.c_int,                        # hs, ws, n
        ctypes.c_void_p,                                 # dst
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # S, letterbox, u8
        ctypes.c_int,                                    # threads
        f32p, f32p, f32p]                                # scales, pads
    lib.preproc_batch.restype = None
    lib.decode_preproc_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,   # paths, n
        ctypes.c_void_p,                                 # dst
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # S, letterbox, u8
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # max_denom, flags,
                                                         # threads
        i32p, i32p,                                      # orig_ws, orig_hs
        f32p, f32p, f32p,                                # scales, pads
        i32p, ctypes.c_char_p, ctypes.c_int]             # codes, msgs, len
    lib.decode_preproc_batch.restype = None
    lib.jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,   # paths, n
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # threads, denom,
                                                         # flags
        ctypes.POINTER(ctypes.c_void_p),                 # pixels (out)
        i32p, i32p, i32p,                                # ws, hs, codes
        ctypes.c_char_p, ctypes.c_int]                   # msgs, msg_len
    lib.jpeg_decode_batch.restype = None
    lib.jpeg_free.argtypes = [ctypes.c_void_p]
    lib.jpeg_free.restype = None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.png_unfilter.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,   # raw, len, w, h
        ctypes.c_int, ctypes.c_int, ctypes.c_int,          # depth, color,
                                                           # interlace
        u8p, ctypes.c_int, u8p,                            # palette, n, rgb
        ctypes.c_char_p, ctypes.c_int]                     # msg, msg_len
    lib.png_unfilter.restype = ctypes.c_int
    lib.exif_orientation.argtypes = [u8p, ctypes.c_int64]
    lib.exif_orientation.restype = ctypes.c_int
    lib.image_orient.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, u8p, i32p, i32p]
    lib.image_orient.restype = None
    lib.webp_vp8.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                             u8p, ctypes.c_char_p, ctypes.c_int]
    lib.webp_vp8.restype = ctypes.c_int
    lib.webp_vp8l.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, u8p, ctypes.c_char_p,
                              ctypes.c_int]
    lib.webp_vp8l.restype = ctypes.c_int
    for name in ("tiff_lzw", "tiff_packbits"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                       ctypes.c_char_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    ci = ctypes.c_int
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.tiff_fax.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64, ci,
                             ci, ci, ci, i32p, u32p, ctypes.c_char_p, ci]
    lib.tiff_fax.restype = ci
    lib.tiff_fax_runs.argtypes = [ci, ci, ci]
    lib.tiff_fax_runs.restype = ctypes.c_int64
    lib.tiff_thunder.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                                 ci, ctypes.c_char_p, ci]
    lib.tiff_thunder.restype = ci
    lib.tiff_sgilog.argtypes = [u8p, ctypes.c_int64, u32p,
                                ctypes.c_int64, ci, ci, ctypes.c_char_p, ci]
    lib.tiff_sgilog.restype = ci
    lib.jpeg_decode_tiff.argtypes = [u8p, ctypes.c_int64, u8p,
                                     ctypes.c_int64, ci, ci, ci, ci, ci, ci,
                                     ci, u8p, ctypes.c_char_p, ci]
    lib.jpeg_decode_tiff.restype = ci
    lib.j2k_decode.argtypes = [u8p, ctypes.c_int64, _J2K_ALLOC, i32p,
                               ctypes.c_char_p, ctypes.c_int]
    lib.j2k_decode.restype = ctypes.c_int
    lib.gif_lzw.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, u8p,
                            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    lib.gif_lzw.restype = ctypes.c_int64
    lib.av1_probe.argtypes = [u8p, ctypes.c_int64, ci, ci, i32p,
                              ctypes.c_char_p, ci]
    lib.av1_probe.restype = ci
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.av1_decode.argtypes = [u8p, ctypes.c_int64, ci, ci, u16p, u16p,
                               u16p, i32p, ctypes.c_char_p, ci]
    lib.av1_decode.restype = ci
    lib.av1_frame_marks.argtypes = [u8p, ctypes.c_int64, ci, i32p, ci,
                                    ctypes.c_char_p, ci]
    lib.av1_frame_marks.restype = ci
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the host library (csrc/preproc.cc, "
                           f"csrc/jpeg_decode.cc) could not be built: "
                           f"{build_error}")
    return lib


def _check_denom(denom: int) -> None:
    if denom not in DENOMS:
        raise ValueError(f"denom must be one of {DENOMS}, got {denom}")


def _threads(n: int) -> int:
    return max(1, min(n, os.cpu_count() or 1))


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def batch_out(out: Optional[np.ndarray], n: int, size: int,
              u8: bool) -> np.ndarray:
    """``out``, checked to be a writable C-contiguous [n, S, S, 3] array of
    the resize's dtype (uint8 or float32), or a new one."""
    dtype = np.dtype(np.uint8 if u8 else np.float32)
    if out is None:
        return np.empty((n, size, size, 3), dtype)
    if (out.shape != (n, size, size, 3) or out.dtype != dtype
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous "
                         f"{(n, size, size, 3)} {dtype} array, got "
                         f"{out.shape} {out.dtype}")
    return out


def preproc_batch(images: List[np.ndarray], size: int, letterbox: bool,
                  out: Optional[np.ndarray] = None, u8: bool = False
                  ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]]:
    """[HWC u8 RGB, ...] -> (batch [N, S, S, 3], scales, pad_xs, pad_ys):
    float32 in [0, 1], or with ``u8`` uint8 (cv2's INTER_LINEAR), written
    into ``out`` when given, on one thread per image up to the CPU count.
    Returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(images)
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    for im in images:
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"preproc_batch takes [H, W, 3] images, got "
                             f"{im.shape}")
    dst = batch_out(out, n, size, u8)
    srcs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p).value for im in images])
    hs = np.asarray([im.shape[0] for im in images], np.int32)
    ws = np.asarray([im.shape[1] for im in images], np.int32)
    scales, pad_xs, pad_ys = (np.empty((n,), np.float32) for _ in range(3))
    lib.preproc_batch(srcs, _i32(hs), _i32(ws), n, dst.ctypes.data, size,
                      int(letterbox), int(u8), _threads(n), _f32(scales),
                      _f32(pad_xs), _f32(pad_ys))
    return dst, scales, pad_xs, pad_ys


def _raise_first(paths: Sequence[str], codes: np.ndarray, msgs) -> None:
    raw = msgs.raw
    for i, path in enumerate(paths):
        if codes[i] != JPEG_OK:
            reason = raw[i * MSG_LEN:(i + 1) * MSG_LEN].split(bytes(1), 1)[0]
            raise JpegError(f"{path}: {reason.decode(errors='replace')}")


def decode_preproc_batch(paths: Sequence[str], size: int, letterbox: bool,
                         out: Optional[np.ndarray] = None, u8: bool = False,
                         max_denom: int = 1, exif: bool = False,
                         imread: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray, np.ndarray]:
    """JPEG files -> (batch [N, S, S, 3], orig_ws, orig_hs, scales,
    pad_xs, pad_ys) with one call: each worker thread (one per file up to
    the CPU count) takes the next file, reads it once, decodes it into
    buffers it reuses and resizes it straight into its slot of ``out`` (or
    of a new array), float32 in [0, 1] or with ``u8`` uint8.

    The decode is at 1/d scale (libjpeg's ``scale_denom``), d the largest
    power of two up to ``max_denom`` that the JAX package's fused loader
    picks for the file: both sides at least twice ``size`` at each step
    (:data:`MAX_DENOM` there; the default 1 decodes at full scale).
    orig_ws / orig_hs are the files' own sizes, and with letterbox the
    scales map their pixels.  With ``exif`` each image is first turned by
    its file's EXIF orientation, and the sizes are the turned image's;
    with ``imread`` CMYK and YCCK files decode as ``cv2.imread`` decodes
    them, without it they fail, as libjpeg's RGB output refuses them.
    Raises :class:`JpegError` naming the first file that fails, once every
    file is done; it is not decoded again.  :func:`decode_preproc_codes`
    is the same call with a status for each file instead."""
    *batch, codes, msgs = _decode_preproc(paths, size, letterbox, out, u8,
                                          max_denom, exif, imread)
    _raise_first(paths, codes, msgs)
    return tuple(batch)


def decode_preproc_codes(paths: Sequence[str], size: int, letterbox: bool,
                         out: Optional[np.ndarray] = None, u8: bool = False,
                         max_denom: int = 1, exif: bool = False,
                         imread: bool = False):
    """:func:`decode_preproc_batch` that does not raise: (batch, orig_ws,
    orig_hs, scales, pad_xs, pad_ys, codes), codes[i] ``JPEG_OK`` (0) where
    file i was decoded into slot i, else csrc/jpeg_decode.h's Code and slot
    i left as it was -- the JAX package's ``ok[i]``."""
    return tuple(_decode_preproc(paths, size, letterbox, out, u8, max_denom,
                                 exif, imread)[:-1])


def _decode_preproc(paths, size, letterbox, out, u8, max_denom, exif, imread):
    lib = _lib_or_raise()
    _check_denom(max_denom)
    n = len(paths)
    dst = batch_out(out, n, size, u8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    orig_ws, orig_hs, codes = (np.zeros(n, np.int32) for _ in range(3))
    scales, pad_xs, pad_ys = (np.empty((n,), np.float32) for _ in range(3))
    msgs = ctypes.create_string_buffer(max(n, 1) * MSG_LEN)
    lib.decode_preproc_batch(c_paths, n, dst.ctypes.data, size,
                             int(letterbox), int(u8), int(max_denom),
                             _flags(exif, imread), _threads(n), _i32(orig_ws),
                             _i32(orig_hs),
                             _f32(scales), _f32(pad_xs), _f32(pad_ys),
                             _i32(codes), msgs, MSG_LEN)
    return dst, orig_ws, orig_hs, scales, pad_xs, pad_ys, codes, msgs


def _owned(lib: ctypes.CDLL, ptr: int, h: int, w: int) -> np.ndarray:
    """The decoder's buffer at ``ptr`` as uint8 [h, w, 3], without a copy;
    the buffer is freed when the last array over it goes."""
    buf = (ctypes.c_uint8 * (h * w * 3)).from_address(ptr)
    weakref.finalize(buf, lib.jpeg_free, ptr)
    return np.frombuffer(buf, np.uint8).reshape(h, w, 3)


def decode_batch(paths: Sequence[str], threads: Optional[int] = None,
                 denom: int = 1, exif: bool = False,
                 imread: bool = False) -> List[np.ndarray]:
    """JPEG files -> [uint8 [H, W, 3] RGB, ...], decoded at 1/``denom``
    scale (libjpeg's ``scale_denom``: 1, 2, 4 or 8; H = ceil(height /
    denom), W likewise) with one call on ``threads`` threads (default one
    per file up to the CPU count); with ``exif`` turned by each file's
    EXIF orientation; with ``imread`` CMYK and YCCK files decoded as
    ``cv2.imread`` decodes them (else they fail).  Raises :class:`JpegError` naming the first file
    that fails."""
    lib = _lib_or_raise()
    _check_denom(denom)
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    pixels = (ctypes.c_void_p * n)()
    ws, hs, codes = (np.zeros(n, np.int32) for _ in range(3))
    msgs = ctypes.create_string_buffer(n * MSG_LEN)
    threads = _threads(n) if threads is None else threads
    lib.jpeg_decode_batch(c_paths, n, int(threads), int(denom),
                          _flags(exif, imread),
                          pixels, _i32(ws), _i32(hs), _i32(codes), msgs,
                          MSG_LEN)
    out = [_owned(lib, p, int(h), int(w)) if p else None
           for p, w, h in zip(pixels, ws, hs)]
    _raise_first(paths, codes, msgs)
    return out


def decode_one(path: str, denom: int = 1, exif: bool = False,
               imread: bool = False) -> np.ndarray:
    """One JPEG file -> uint8 [H, W, 3] RGB at 1/``denom`` scale, turned
    by its EXIF orientation with ``exif``, CMYK and YCCK decoded with
    ``imread``; raises :class:`JpegError`."""
    return decode_batch([path], threads=1, denom=denom, exif=exif,
                        imread=imread)[0]


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _png_unfilter(raw: bytes, w: int, h: int, depth: int, color: int,
                  interlace: int, palette: bytes) -> np.ndarray:
    lib = _lib_or_raise()
    src = np.frombuffer(raw, np.uint8)
    pal = np.frombuffer(palette or bytes(3), np.uint8)
    rgb = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(MSG_LEN)
    code = lib.png_unfilter(_u8(src), len(src), w, h, depth, color,
                            interlace, _u8(pal), len(palette) // 3, _u8(rgb),
                            msg, MSG_LEN)
    if code != JPEG_OK:
        from objectdetectionpl_tpu_torch.data.formats import FormatError
        raise FormatError(msg.value.decode(errors="replace"))
    return rgb


def _format_error(msg) -> Exception:
    from objectdetectionpl_tpu_torch.data.formats import FormatError
    return FormatError(msg.value.decode(errors="replace"))


def _webp_vp8(body: bytes, w: int, h: int) -> np.ndarray:
    src = np.frombuffer(body, np.uint8)
    rgb = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(MSG_LEN)
    if _lib_or_raise().webp_vp8(_u8(src), len(src), w, h, _u8(rgb), msg,
                                MSG_LEN):
        raise _format_error(msg)
    return rgb


def _webp_vp8l(body: bytes, w: int, h: int, headerless: bool = False
               ) -> Optional[np.ndarray]:
    src = np.frombuffer(body or bytes(1), np.uint8)
    rgb = None if headerless else np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(MSG_LEN)
    if _lib_or_raise().webp_vp8l(_u8(src), len(body), int(headerless), w, h,
                                 None if rgb is None else _u8(rgb), msg,
                                 MSG_LEN):
        raise _format_error(msg)
    return rgb


def _webp_alpha(stream: bytes, w: int, h: int) -> None:
    _webp_vp8l(stream, w, h, headerless=True)


# The TIFF codecs return (bytes, ok): ok False where libtiff's codec
# fails the strip, the bytes then what it wrote before, zeros after.

def _tiff_codec(name: str):
    def decode(raw: bytes, size: int) -> Tuple[bytes, bool]:
        src = np.frombuffer(raw or bytes(1), np.uint8)
        dst = np.empty(max(size, 1), np.uint8)
        msg = ctypes.create_string_buffer(MSG_LEN)
        code = getattr(_lib_or_raise(), name)(_u8(src), len(raw), _u8(dst),
                                              size, msg, MSG_LEN)
        return dst[:size].tobytes(), code == JPEG_OK
    return decode


def _tiff_fax(raw: bytes, rows: int, width: int, kind: int, options: int,
              fill_order: int, state: dict) -> Tuple[bytes, bool]:
    """``state`` carries libtiff's fax codec from strip to strip of one
    image: its mode (``noeol``) and its run arrays (``runs``)."""
    lib = _lib_or_raise()
    src = np.frombuffer(raw or bytes(1), np.uint8)
    size = rows * ((width + 7) // 8)
    dst = np.empty(max(size, 1), np.uint8)
    noeol = np.array([int(state.get("noeol", 0))], np.int32)
    if "runs" not in state:
        state["runs"] = np.zeros(lib.tiff_fax_runs(width, kind, options),
                                 np.uint32)
    msg = ctypes.create_string_buffer(MSG_LEN)
    code = lib.tiff_fax(_u8(src), len(raw), _u8(dst), rows, width, kind,
                        options, fill_order, _i32(noeol),
                        state["runs"].ctypes.data_as(ctypes.POINTER(
                            ctypes.c_uint32)), msg, MSG_LEN)
    state["noeol"] = int(noeol[0])
    return dst[:size].tobytes(), code == JPEG_OK


def _tiff_jpeg(tables: bytes, raw: bytes, w: int, h: int, comps: int,
               to_rgb: bool, hs: int, vs: int,
               taller_ok: bool) -> Tuple[bytes, bool]:
    """One JPEG strip or tile of a TIFF -> its samples (RGB with
    ``to_rgb``), by ``csrc/jpeg_decode.cc::jpeg_decode_tiff``; raises
    where libtiff fails before the strip's buffer exists (the stream's
    header, its frame against the TIFF's)."""
    t = np.frombuffer(tables or bytes(1), np.uint8)
    src = np.frombuffer(raw or bytes(1), np.uint8)
    out = np.empty(w * h * (3 if to_rgb else comps), np.uint8)
    msg = ctypes.create_string_buffer(MSG_LEN)
    if _lib_or_raise().jpeg_decode_tiff(
            _u8(t), len(tables), _u8(src), len(raw), int(to_rgb), w, h,
            comps, hs, vs, int(taller_ok), _u8(out), msg, MSG_LEN):
        raise _format_error(msg)
    return out.tobytes(), True


def _tiff_thunder(raw: bytes, rows: int, width: int) -> Tuple[bytes, bool]:
    src = np.frombuffer(raw or bytes(1), np.uint8)
    size = rows * ((width + 1) // 2)
    dst = np.empty(max(size, 1), np.uint8)
    msg = ctypes.create_string_buffer(MSG_LEN)
    code = _lib_or_raise().tiff_thunder(_u8(src), len(raw), _u8(dst), rows,
                                        width, msg, MSG_LEN)
    return dst[:size].tobytes(), code == JPEG_OK


def _tiff_sgilog(raw: bytes, rows: int, width: int,
                 nbytes: int) -> Tuple[np.ndarray, bool]:
    """SGILog rows -> uint32 [rows * width] LogL (nbytes 2) or LogLuv
    (4) values."""
    src = np.frombuffer(raw or bytes(1), np.uint8)
    dst = np.empty(max(rows * width, 1), np.uint32)
    msg = ctypes.create_string_buffer(MSG_LEN)
    code = _lib_or_raise().tiff_sgilog(
        _u8(src), len(raw), dst.ctypes.data_as(ctypes.POINTER(
            ctypes.c_uint32)), rows, width, nbytes, msg, MSG_LEN)
    return dst[:rows * width], code == JPEG_OK


TIFF_CODECS = {"lzw": _tiff_codec("tiff_lzw"),
               "packbits": _tiff_codec("tiff_packbits"),
               "fax": _tiff_fax, "jpeg": _tiff_jpeg,
               "thunder": _tiff_thunder, "sgilog": _tiff_sgilog}


# int32* alloc(ncomp, h, w): the decoder's output buffer, null if none
_J2K_ALLOC = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int)


def _j2k_decode(codestream: bytes) -> Tuple[np.ndarray, int]:
    """A J2K codestream -> (int32 [ncomp, h, w] samples, the largest
    component precision), or FormatError with what cv2 refuses."""
    src = np.frombuffer(codestream or bytes(1), np.uint8)
    out: List[np.ndarray] = []

    def alloc(n, h, w):
        try:
            out.append(np.empty((n, h, w), np.int32))
        except MemoryError:
            return None
        return out[0].ctypes.data

    prec = np.zeros(1, np.int32)
    msg = ctypes.create_string_buffer(MSG_LEN)
    if _lib_or_raise().j2k_decode(_u8(src), len(codestream),
                                  _J2K_ALLOC(alloc), _i32(prec), msg,
                                  MSG_LEN):
        raise _format_error(msg)
    return out[0], int(prec[0])


def _gif_lzw(codes: bytes, min_code_size: int, npix: int):
    src = np.frombuffer(codes or bytes(1), np.uint8)
    dst = np.zeros(npix, np.uint8)
    msg = ctypes.create_string_buffer(MSG_LEN)
    count = _lib_or_raise().gif_lzw(_u8(src), len(codes), min_code_size,
                                    _u8(dst), npix, msg, MSG_LEN)
    if count < 0:
        raise _format_error(msg)
    return dst, int(count)


AV1_INFO = ("width", "height", "subsampling_x", "subsampling_y",
            "monochrome", "bit_depth", "full_range", "matrix", "primaries",
            "transfer", "restoration_y", "restoration_u", "restoration_v",
            "superres_denom", "apply_grain", "superblock", "tile_cols",
            "coded_width", "screen_content_tools", "intrabc",
            "operating_points", "frames")
# what the stream used, as ``av1_decode`` counts it
AV1_COUNTS = ("palette_y_blocks", "palette_uv_blocks", "palette_sizes",
              "intrabc_blocks", "intrabc_default_dv", "frames",
              "inter_frames", "shown_existing", "inter_blocks",
              "compound_blocks", "obmc_blocks", "warp_blocks",
              "interintra_blocks", "scaled_blocks",
              "temporal_mvs", "dual_filter_blocks",
              "wedge_compound_blocks", "diffwtd_compound_blocks",
              "distance_blocks", "wedge_interintra_blocks",
              "scaled_compound_blocks", "global_warp_blocks",
              "global_shift_blocks", "grey_slots", "grey_blocks")


def av1_probe(stream: bytes, operating_point: int = 0,
              layer: int = -1) -> dict:
    """The headers of an AV1 item's OBUs, by ``csrc/av1_decode.cc``'s
    ``av1_probe``: ``AV1_INFO`` -> value.  The width and height are the
    shown frame's (the last one shown, as libaom hands libavif; the
    width the upscaled one) and so is apply_grain; the other frame fields
    are the last frame header's (restoration types 0 none, 1 Wiener, 2
    self-guided, 3 switchable; superres_denom 8 without superres);
    ``operating_point`` selects the layers decoded (a1op's index; 0 where
    the stream has fewer points), ``layer`` (lsel's, -1 for none) the
    spatial layer whose first shown frame is the output; frames counts
    the frame headers parsed.  FormatError with the tool it refuses."""
    lib = _lib_or_raise()
    src = np.frombuffer(stream or bytes(1), np.uint8)
    info = np.zeros(len(AV1_INFO), np.int32)
    msg = ctypes.create_string_buffer(MSG_LEN)
    if lib.av1_probe(_u8(src), len(stream), operating_point, layer,
                     _i32(info), msg, MSG_LEN):
        raise _format_error(msg)
    return dict(zip(AV1_INFO, (int(v) for v in info)))


AV1_MARKS = ("obu", "payload", "size", "gm_start", "gm_end", "header_end",
             "obu_type", "flags")


def av1_frame_marks(stream: bytes, operating_point: int = 0) -> list:
    """Where each frame header of an AV1 item's OBUs lies, by
    ``csrc/av1_decode.cc``'s ``av1_frame_marks``: one dict a header, in
    stream order, of ``AV1_MARKS`` (the OBU's byte offset, its payload's
    offset and size, the payload bits [gm_start, gm_end) of
    global_motion_params, -1 in a frame shown again, and the header's
    end bit) with ``frame_type`` and ``high_precision_mv``
    (allow_high_precision_mv) from the flags.  For
    the writers that rewrite a header (``tools/format_files.py``);
    FormatError where the headers do not parse."""
    lib = _lib_or_raise()
    src = np.frombuffer(stream or bytes(1), np.uint8)
    cap = 64
    while True:
        out = np.zeros((cap, len(AV1_MARKS)), np.int32)
        msg = ctypes.create_string_buffer(MSG_LEN)
        n = lib.av1_frame_marks(_u8(src), len(stream), operating_point,
                                _i32(out), cap, msg, MSG_LEN)
        if n < 0:
            raise _format_error(msg)
        if n <= cap:
            break
        cap = n
    marks = []
    for row in out[:n]:
        m = dict(zip(AV1_MARKS, (int(v) for v in row)))
        f = m.pop("flags")
        m.update(frame_type=f & 3, high_precision_mv=f >> 2 & 1)
        marks.append(m)
    return marks


def _av1(stream: bytes, operating_point: int = 0, layer: int = -1):
    """An AV1 item's OBUs -> ([Y, U, V] uint16 planes at the stream's bit
    depth, or [Y] for a monochrome stream, of the frame libaom hands
    libavif: the last one shown in the operating point's layers, or the
    first one of spatial layer ``layer`` where lsel selects it; and the
    sequence header's bit depth and colour fields with what the stream
    used, ``AV1_COUNTS``: blocks with a Y or UV palette, the palette
    sizes, intra block copy blocks and those whose reference vector was
    the default, the frames, inter frames, frames shown from a reference
    slot, inter, compound, OBMC, local-warp, inter-intra and
    scaled-reference blocks, temporal vector candidates, blocks with
    two different interpolation filters, wedge,
    difference-weighted and distance-weighted compound blocks, wedge
    inter-intra blocks, compound blocks from a scaled reference, GLOBALMV
    blocks warped by their reference's global motion and those moved by
    it, slots filled in for a lost frame and blocks predicted from
    them), by ``csrc/av1_decode.cc``; FormatError with the tool it
    refuses."""
    lib = _lib_or_raise()
    src = np.frombuffer(stream or bytes(1), np.uint8)
    info = av1_probe(stream, operating_point, layer)
    w, h, sx, sy, mono = (info[k] for k in AV1_INFO[:5])
    from objectdetectionpl_tpu_torch.data.formats import check_size
    check_size(w, h)
    cw, ch = (w + sx) >> sx, (h + sy) >> sy
    planes = [np.empty((h, w), np.uint16)] + [
        np.empty((ch, cw), np.uint16) for _ in range(0 if mono else 2)]
    u16p = ctypes.POINTER(ctypes.c_uint16)
    ptrs = [p.ctypes.data_as(u16p) for p in planes]
    ptrs += [None] * (3 - len(ptrs))
    counts = np.zeros(len(AV1_COUNTS), np.int32)
    msg = ctypes.create_string_buffer(MSG_LEN)
    if lib.av1_decode(_u8(src), len(stream), operating_point, layer, *ptrs,
                      _i32(counts), msg, MSG_LEN):
        raise _format_error(msg)
    used = dict(zip(AV1_COUNTS, (int(v) for v in counts)))
    used["palette_sizes"] = [n for n in range(2, 9) if counts[2] >> n & 1]
    return planes, {"subsampling": (sx, sy), "bit_depth": info["bit_depth"],
                    "full_range": info["full_range"],
                    "matrix": info["matrix"], "primaries": info["primaries"],
                    "transfer": info["transfer"], **used}


def _exif_orientation(tiff: bytes) -> int:
    data = np.frombuffer(tiff or bytes(1), np.uint8)
    return int(_lib_or_raise().exif_orientation(_u8(data), len(tiff)))


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """uint8 [H, W, 3] turned by an EXIF orientation as ``cv2.imread``
    turns it (1 and values outside 2..8 leave it as it is)."""
    if not 2 <= orientation <= 8:
        return img
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    out = np.empty((w, h, 3) if orientation >= 5 else (h, w, 3), np.uint8)
    ow, oh = np.zeros(1, np.int32), np.zeros(1, np.int32)
    _lib_or_raise().image_orient(_u8(img), w, h, int(orientation), _u8(out),
                                 _i32(ow), _i32(oh))
    return out


_READERS = ("PNG", "BMP", "WebP", "TIFF", "JPEG 2000", "GIF", "AVIF", "PNM",
            "PAM", "PFM", "Sun raster", "Radiance HDR")   # formats.py's


def decode_image(path: str, exif: bool = True) -> np.ndarray:
    """One image file -> uint8 [H, W, 3] RGB, as ``cv2.imread(path)`` (the
    JAX package's ``load_image_rgb``) reads it: the reader picked by the
    file's first bytes whatever its name (``formats.sniff``), JPEG by the
    port's decoder (CMYK, YCCK and lossless included), PNG, BMP, GIF,
    WebP, TIFF, JPEG 2000, AVIF, PNM, PAM, PFM, Sun raster and Radiance
    HDR by ``data/formats.py``; JPEG, PNG and WebP turned by their EXIF
    orientation with ``exif`` (a TIFF's Orientation tag is its reader's,
    as in cv2; cv2 reads no EXIF from the others, AVIF's included).
    Anything else raises :class:`ImageError` naming the path and the
    format, as does a file that cv2 would not read either, and a TIFF,
    WebP or AVIF of a kind the port does not read, naming the kind.  The
    first 500 bytes pick the reader: cv2's AVIF signature check parses
    that many."""
    from objectdetectionpl_tpu_torch.data import formats
    try:
        with open(path, "rb") as f:
            head = f.read(formats.AVIF_HEAD)
            kind = formats.sniff(head)
            data = head + f.read() if kind in _READERS else b""
    except OSError as e:
        raise ImageError(f"{path}: cannot read the file: {e.strerror}") \
            from None
    if kind == "JPEG":
        return decode_one(path, exif=exif, imread=True)
    try:
        if kind == "PNG":
            img, orientation = formats.read_png(data, _png_unfilter,
                                                _exif_orientation)
            return orient(img, orientation) if exif else img
        if kind == "WebP":
            img, orientation = formats.read_webp(
                data, _webp_vp8, _webp_vp8l, _webp_alpha, _exif_orientation)
            return orient(img, orientation) if exif else img
        if kind == "TIFF":
            return formats.read_tiff(data, TIFF_CODECS)
        if kind == "JPEG 2000":
            return formats.read_jp2(data, _j2k_decode)
        if kind == "GIF":
            return formats.read_gif(data, _gif_lzw)
        if kind == "AVIF":
            return formats.read_avif(data, _av1)
        numpy_only = {"BMP": formats.read_bmp, "PNM": formats.read_pnm,
                      "PAM": formats.read_pam, "PFM": formats.read_pfm,
                      "Sun raster": formats.read_sun,
                      "Radiance HDR": formats.read_hdr}
        if kind in numpy_only:
            return numpy_only[kind](data)
    except formats.FormatError as e:
        raise ImageError(f"{path}: {kind}: {e}") from None
    if kind:    # OpenEXR, which the cv2 build of the tests lacks
        raise ImageError(f"{path}: a {kind} image, which the port does not "
                         f"read")
    raise ImageError(f"{path}: not an image file (no JPEG, PNG, BMP, GIF, "
                     f"WebP, TIFF, JPEG 2000, AVIF, PNM, PAM, PFM, Sun raster "
                     f"or Radiance HDR signature)")
