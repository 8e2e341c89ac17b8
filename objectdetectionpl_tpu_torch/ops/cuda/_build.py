"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``objectdetectionpl_tpu_torch/csrc/<name>.cu`` exports plain C functions
and is compiled on its own into ``build/kernels/lib<name>-<hash>.so`` at the
repository root, the first time it is used:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The hash covers the source and the flags, so a changed source rebuilds and
an unchanged one is loaded as it is.  Sources that include no PyTorch header
build in seconds (PyTorch's extension builder takes minutes).  Wrappers pass
pointers and the stream as ``ctypes.c_void_p``.  A missing ``nvcc`` or a
failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

build_log: Dict[str, str] = {}      # name -> compiler output of its build


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "the port's CUDA kernels need the CUDA toolkit")


def build(names: Optional[Iterable[str]] = None) -> list:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns the names it compiled."""
    todo = [n for n in (sources() if names is None else names)
            if not library_path(n).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{n}.cu "
                                   f"(exit {proc.returncode}):\n{out}")
            os.replace(tmp, library_path(n))
            build_log[n] = out
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return todo


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it first if needed.
    Callers keep the handle (the wrappers cache their configured one)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
