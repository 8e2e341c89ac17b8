"""ctypes bindings of the port's two host libraries: the resize and the
JPEG decoder.

The resize: the port's counterpart of ``objectdetectionpl_tpu/data/native.py``,
the same C function (``preproc_batch``: a multithreaded bilinear resize or
letterbox of uint8 images straight into the float32 NHWC batch, scaled by
1/255), built with the Makefile's flags, but with g++ into
``build/native/libpreproc-<key>.so`` at the repository root, so ``native/``
is left as it is.  Only the part of ``native/preproc.cc`` before its fused
libjpeg decoder is compiled, so the library needs no libjpeg.  Without g++
the build fails, :func:`available` is False, ``build_error`` says why, and
the Loader resizes with torch instead (``pipeline.torch_resize``).

The decoder: ``csrc/jpeg_decode.cc``, the port's own baseline sequential
JPEG decoder (equal bit for bit to libjpeg-turbo's default decompression
to RGB at full scale), built the same way into
``build/native/libjpegdec-<key>.so``.  :func:`decode_batch` decodes a
batch of files on a pool of threads with one call, each file read once by
the thread that decodes it; :func:`decode_one` is a batch of one.  A file it cannot read raises :class:`JpegError` naming the path
and the reason; there is no other decoder to fall back to.  Without g++
:func:`jpeg_available` is False, ``jpeg_build_error`` says why, and the
real datasets raise.

Each key hashes the source, the flags and the host's name: ``-march=native``
code belongs to the machine that built it.  A build runs on first use,
under a file lock, into a temporary file that is renamed into place.
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
SOURCE = REPO / "native" / "preproc.cc"
JPEG_SOURCE = REPO / "objectdetectionpl_tpu_torch" / "csrc" / "jpeg_decode.cc"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread", "-Wall")
BUILD_TIMEOUT_S = 300

_lib = None
_load_failed = False
build_error: Optional[str] = None   # why the resize library is unavailable
_jpeg_lib = None
_jpeg_load_failed = False
jpeg_build_error: Optional[str] = None   # why the decoder is unavailable


JPEG_SECTION = b"// Fused JPEG decode"   # where the libjpeg part begins


def resize_source() -> bytes:
    """``preproc.cc`` up to its fused JPEG decoder: ``preproc_batch``."""
    text = SOURCE.read_bytes()
    cut = text.find(JPEG_SECTION)
    if cut < 0:
        raise ValueError(f"{SOURCE} has no {JPEG_SECTION.decode()!r} section")
    return text[:cut]


def _library_path(name: str, source: bytes) -> Path:
    key = hashlib.sha256(source + " ".join(CXX_FLAGS).encode()
                         + platform.node().encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def library_path() -> Path:
    return _library_path("preproc", resize_source())


def jpeg_library_path() -> Path:
    return _library_path("jpegdec", JPEG_SOURCE.read_bytes())


def _build(name: str, source: bytes) -> Path:
    """Compile ``source`` unless its library exists.  Raises OSError (no
    compiler) or SubprocessError (a failed build)."""
    lib = _library_path(name, source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # one build per library at once
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-x",
                            "c++", "-", "-o", str(tmp)], input=source,
                           check=True, capture_output=True,
                           timeout=BUILD_TIMEOUT_S)
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return lib


def build() -> Path:
    """Compile the resize part of ``native/preproc.cc``."""
    return _build("preproc", resize_source())


def jpeg_build() -> Path:
    """Compile the decoder, ``csrc/jpeg_decode.cc``."""
    return _build("jpegdec", JPEG_SOURCE.read_bytes())


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
    lib.preproc_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),                 # srcs
        ctypes.POINTER(ctypes.c_int),                    # hs
        ctypes.POINTER(ctypes.c_int),                    # ws
        ctypes.c_int,                                    # n
        ctypes.POINTER(ctypes.c_float),                  # dst
        ctypes.c_int, ctypes.c_int, ctypes.c_int,        # S, letterbox, threads
        ctypes.POINTER(ctypes.c_float),                  # scales
        ctypes.POINTER(ctypes.c_float),                  # pad_xs
        ctypes.POINTER(ctypes.c_float),                  # pad_ys
    ]
    lib.preproc_batch.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def preproc_batch(images: List[np.ndarray], size: int, letterbox: bool
                  ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]]:
    """[HWC u8 RGB, ...] -> (batch [N,S,S,3] f32 in [0,1], scales, pad_xs,
    pad_ys), on one thread per image up to the CPU count.  Returns None
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(images)
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    for im in images:
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"preproc_batch takes [H, W, 3] images, got "
                             f"{im.shape}")
    srcs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p).value for im in images])
    hs = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    ws = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    dst = np.empty((n, size, size, 3), np.float32)
    scales = np.empty((n,), np.float32)
    pad_xs = np.empty((n,), np.float32)
    pad_ys = np.empty((n,), np.float32)
    threads = min(n, os.cpu_count() or 1)
    f32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.preproc_batch(srcs, hs, ws, n, f32(dst), size, int(letterbox),
                      threads, f32(scales), f32(pad_xs), f32(pad_ys))
    return dst, scales, pad_xs, pad_ys


# --- the JPEG decoder -------------------------------------------------------

JPEG_OK = 0              # csrc/jpeg_decode.cc's codes; any other is an error
MSG_LEN = 256


class JpegError(ValueError):
    """A file the decoder cannot read: the message names the path."""


def _jpeg_load() -> Optional[ctypes.CDLL]:
    global _jpeg_lib, _jpeg_load_failed, jpeg_build_error
    if _jpeg_lib is not None or _jpeg_load_failed:
        return _jpeg_lib
    try:
        lib = ctypes.CDLL(str(jpeg_build()))
    except (OSError, subprocess.SubprocessError) as e:
        _jpeg_load_failed = True
        jpeg_build_error = _why(e)
        return None
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,   # paths, n
        ctypes.c_int,                                    # threads
        ctypes.POINTER(ctypes.c_void_p),                 # pixels (out)
        i32p, i32p, i32p,                                # ws, hs, codes
        ctypes.c_char_p, ctypes.c_int]                   # msgs, msg_len
    lib.jpeg_decode_batch.restype = None
    lib.jpeg_free.argtypes = [ctypes.c_void_p]
    lib.jpeg_free.restype = None
    _jpeg_lib = lib
    return _jpeg_lib


def jpeg_available() -> bool:
    return _jpeg_load() is not None


def _jpeg_lib_or_raise() -> ctypes.CDLL:
    lib = _jpeg_load()
    if lib is None:
        raise RuntimeError(f"the JPEG decoder (csrc/jpeg_decode.cc) could "
                           f"not be built: {jpeg_build_error}")
    return lib


def _owned(lib: ctypes.CDLL, ptr: int, h: int, w: int) -> np.ndarray:
    """The decoder's buffer at ``ptr`` as uint8 [h, w, 3], without a copy;
    the buffer is freed when the last array over it goes."""
    buf = (ctypes.c_uint8 * (h * w * 3)).from_address(ptr)
    weakref.finalize(buf, lib.jpeg_free, ptr)
    return np.frombuffer(buf, np.uint8).reshape(h, w, 3)


def decode_batch(paths: Sequence[str], threads: Optional[int] = None
                 ) -> List[np.ndarray]:
    """JPEG files -> [uint8 [H, W, 3] RGB, ...], decoded with one call on
    ``threads`` threads (default one per file up to the CPU count).  Raises
    :class:`JpegError` naming the first file that fails."""
    lib = _jpeg_lib_or_raise()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    pixels = (ctypes.c_void_p * n)()
    ws = np.zeros(n, np.int32)
    hs = np.zeros(n, np.int32)
    codes = np.zeros(n, np.int32)
    msgs = ctypes.create_string_buffer(n * MSG_LEN)
    i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    threads = min(n, os.cpu_count() or 1) if threads is None else threads
    lib.jpeg_decode_batch(c_paths, n, int(threads), pixels, i32(ws), i32(hs),
                          i32(codes), msgs, MSG_LEN)
    out = [_owned(lib, p, int(h), int(w)) if p else None
           for p, w, h in zip(pixels, ws, hs)]
    raw = msgs.raw
    for i, path in enumerate(paths):
        if codes[i] != JPEG_OK:
            reason = raw[i * MSG_LEN:(i + 1) * MSG_LEN].split(bytes(1), 1)[0]
            raise JpegError(f"{path}: {reason.decode(errors='replace')}")
    return out


def decode_one(path: str) -> np.ndarray:
    """One JPEG file -> uint8 [H, W, 3] RGB; raises :class:`JpegError`."""
    return decode_batch([path], threads=1)[0]
