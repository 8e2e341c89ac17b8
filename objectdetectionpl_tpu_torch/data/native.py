"""ctypes binding of the native host preprocessing library ``native/preproc.cc``.

The port's counterpart of ``objectdetectionpl_tpu/data/native.py``: the same
C function (``preproc_batch``: a multithreaded bilinear resize or letterbox
of uint8 images straight into the float32 NHWC batch, scaled by 1/255),
built with the Makefile's flags, but with g++ into
``build/native/libpreproc-<key>.so`` at the repository root, so
``native/`` is left as it is.  Only the part of the source before its fused
JPEG decoder is compiled, so the library needs no libjpeg: the port does
not bind the decoder yet.  The key hashes that source, the flags and the
host's name: ``-march=native`` code belongs to the machine that built it.
The build runs on first use.  Without g++ the build fails,
:func:`available` is False, ``build_error`` says why, and the Loader
resizes with torch instead (``pipeline.torch_resize``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "preproc.cc"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread", "-Wall")
BUILD_TIMEOUT_S = 300

_lib = None
_load_failed = False
build_error: Optional[str] = None   # why the library is unavailable


JPEG_SECTION = b"// Fused JPEG decode"   # where the libjpeg part begins


def resize_source() -> bytes:
    """``preproc.cc`` up to its fused JPEG decoder: ``preproc_batch``."""
    text = SOURCE.read_bytes()
    cut = text.find(JPEG_SECTION)
    if cut < 0:
        raise ValueError(f"{SOURCE} has no {JPEG_SECTION.decode()!r} section")
    return text[:cut]


def library_path() -> Path:
    key = hashlib.sha256(resize_source() + " ".join(CXX_FLAGS).encode()
                         + platform.node().encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpreproc-{key}.so"


def build() -> Path:
    """Compile the resize part of ``native/preproc.cc`` unless its library
    exists.  Raises OSError (no compiler) or SubprocessError (a failed
    build)."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-x", "c++",
                        "-", "-o", str(tmp)], input=resize_source(),
                       check=True, capture_output=True,
                       timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, build_error
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError) as e:
        _load_failed = True
        stderr = getattr(e, "stderr", None) or b""
        build_error = f"{type(e).__name__}: {e} {stderr.decode()[-400:]}"
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
