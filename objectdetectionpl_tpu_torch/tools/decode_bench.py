"""Host timing of the port's JPEG decoder: ``native.decode_batch`` over
copies of each file at each DCT scale and thread count.

Run from a checkout's root:

    python3 -m objectdetectionpl_tpu_torch.tools.decode_bench \\
        [--files a.jpg ...] [--denoms 1 2 4 8] [--threads 1 8] \\
        [--copies 32] [--reps 3]

or, to time another checkout's decoder (say an older commit unpacked into
``build/parent``, whose ``decode_batch`` has no ``denom``: full scale
only) on this checkout's files:

    cd build/parent && PYTHONPATH=. python3 \\
        ../../objectdetectionpl_tpu_torch/tools/decode_bench.py --denoms 1

It prints one JSON line per file, scale and thread count: ms per image
(the best of ``--reps`` calls on ``--copies`` copies of the file, after a
warm call) and output megapixels per second, with the package measured,
``os.cpu_count()`` and the card's name and power limit where
``nvidia-smi`` answers.  The default files are the committed 1280x720
frames (BDD100K's size), baseline and progressive; the default thread
counts 1 and ``os.cpu_count()``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

import objectdetectionpl_tpu_torch as pkg
from objectdetectionpl_tpu_torch.data import native

TESTDATA = Path(__file__).resolve().parents[1] / "data" / "testdata"
FRAMES = ("bdd_420_q75_1280x720.jpg", "bdd_progressive_420_q75_1280x720.jpg")


def time_decode(path: str, denom: int = 1, threads: int = 1,
                copies: int = 32, reps: int = 3) -> dict:
    """ms per image of ``decode_batch`` on ``copies`` copies of ``path`` at
    1/denom on ``threads`` threads: the best of ``reps`` calls."""
    kw = {"denom": denom} if denom != 1 else {}
    paths = [path] * copies
    first = native.decode_batch(paths[:threads], threads=threads, **kw)
    h, w = first[0].shape[:2]
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        native.decode_batch(paths, threads=threads, **kw)
        best = min(best, time.perf_counter() - t0)
    return {"file": os.path.basename(path), "denom": denom,
            "threads": threads, "out": [h, w],
            "ms_per_image": best * 1e3 / copies,
            "mp_per_s": h * w * copies / 1e6 / best}


def card() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--files", nargs="+",
                        default=[str(TESTDATA / n) for n in FRAMES])
    parser.add_argument("--denoms", nargs="+", type=int, default=[1, 2, 4, 8])
    parser.add_argument("--threads", nargs="+", type=int,
                        default=sorted({1, os.cpu_count() or 1}))
    parser.add_argument("--copies", type=int, default=32)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    common = {"package": os.path.dirname(pkg.__file__),
              "cpu_count": os.cpu_count(), "card": card()}
    for path in args.files:
        for denom in args.denoms:
            for threads in args.threads:
                print(json.dumps({"decode_time": time_decode(
                    path, denom, threads, args.copies, args.reps),
                    **common}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
