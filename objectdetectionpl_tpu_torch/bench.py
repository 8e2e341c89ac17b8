"""Benchmark: YOLOv5s-640 end-to-end images/sec on one card (preproc +
infer + NMS).

The port of the repository's ``bench.py`` chain (``bench.py:54-140``):
YOLOv5s, 10 classes (BDD100K's), bfloat16, random weights from seed 0, the
/255 folded into the stem conv, uint8 ``[B, 640, 640, 3]`` in.  The chain is
``utils/export.py::build_inference_fn``'s module: cast -> forward -> decode
(the dense ``decode_yolov5_predictions``, or with ``--prefilter``
``decode_select_yolov5``) -> ``yolo_nms`` (top-k 300, the NMS kernel).

    python -m objectdetectionpl_tpu_torch.bench [--prefilter] \\
        [--batch 256] [--iters 20] [--device cpu]

As ``bench.py``'s ``fori_loop`` chains its iterations, each iteration's
input is ``raw + acc % 2`` and ``acc += valid.sum()`` on the device, so
nothing leaves the card until the one read of ``acc`` at the end; the
time runs from before the first timed iteration to that read.  WARMUP
iterations run first.  On CUDA every iteration must launch the NMS kernel
once.  Prints one JSON line: ``bench.py``'s keys, plus ``batch``,
``iters``, ``prefilter``, ``nms_launches`` and the card's name and power
limit (``nvidia-smi``; null on the CPU).  ``--device cpu`` is for the
tests, at a small batch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from objectdetectionpl_tpu_torch.device import resolve_device
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.ops import anchors as anchor_lib
from objectdetectionpl_tpu_torch.ops import nms
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
from objectdetectionpl_tpu_torch.utils import export as export_lib
from objectdetectionpl_tpu_torch.utils import timing

A100_PT_BASELINE_IPS = 250.0   # bench.py's nominal yardstick
BATCH = 256
IMG = 640
WARMUP = 2
ITERS = 20
NUM_CLASSES = 10
TOP_K = 300
CONF_THRES = 0.5
NMS_THRES = 0.4


def postprocess(prefilter: bool, num_classes: int = NUM_CLASSES):
    """bench.py's serving tail: decode (dense, or score -> top-k -> decode
    with ``prefilter``) -> ``yolo_nms``."""
    decode = (nms.decode_select_yolov5 if prefilter
              else nms.decode_yolov5_predictions)
    extra = dict(top_k=TOP_K, conf_thres=CONF_THRES) if prefilter else {}

    def post(outputs):
        preds = decode(outputs, anchor_lib.YOLOV5_ANCHORS,
                       anchor_lib.YOLOV5_STRIDES, num_classes, **extra)
        return nms.yolo_nms(preds, CONF_THRES, NMS_THRES, TOP_K)
    return post


def make_chain(device, prefilter: bool = False, seed: int = 0
               ) -> torch.nn.Module:
    """The benchmarked module: YOLOv5s bf16 from ``seed``, /255 folded."""
    model = build_model("YOLOv5", NUM_CLASSES, dtype=torch.bfloat16,
                        yolov5_type="Yolov5s", device=device, seed=seed)
    return export_lib.build_inference_fn(model, model.state_dict(),
                                         postprocess(prefilter),
                                         fold_preproc=True)


def chained(chain, raw: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` calls, each input perturbed by the running count of valid
    detections: bench.py's ``bench_loop``, with no host sync inside."""
    acc = torch.zeros((), dtype=torch.int64, device=raw.device)
    for _ in range(iters):
        valid = chain(raw + (acc % 2).to(raw.dtype))[4]
        acc += valid.sum()
    return acc


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--prefilter", action="store_true",
                   help="decode_select_yolov5 instead of the dense decode")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which must exist)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    chain = make_chain(device, args.prefilter)
    host = np.random.RandomState(0).randint(
        0, 255, (args.batch, IMG, IMG, 3)).astype(np.uint8)
    raw = torch.from_numpy(host).to(device)
    cuda = device.type == "cuda"
    launches = nms_kernel.LAUNCHES
    with torch.inference_mode():
        for _ in range(WARMUP):
            int(chained(chain, raw, 1))
        t0 = time.perf_counter()
        checksum = int(chained(chain, raw, args.iters))
        dt = time.perf_counter() - t0
    launches = nms_kernel.LAUNCHES - launches
    if cuda and launches != WARMUP + args.iters:
        raise AssertionError(f"greedy_nms launched {launches} times in "
                             f"{WARMUP + args.iters} iterations")
    if checksum < 0:
        raise AssertionError(f"checksum {checksum}")
    ips = args.batch * args.iters / dt
    result = {
        "metric": "YOLOv5s-640 end-to-end images/sec/chip "
                  "(preproc+infer+NMS)",
        "value": round(ips, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(ips / A100_PT_BASELINE_IPS, 3),
        "batch": args.batch, "iters": args.iters, "warmup": WARMUP,
        "prefilter": args.prefilter, "seconds": dt, "checksum": checksum,
        "nms_launches": launches,
        "card": timing.card() if cuda else None,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
