#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py [--profile]

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  -- the card (``nvidia-smi`` name and power limit on a line of
   its own), torch and CUDA versions.
2. build   -- every ``objectdetectionpl_tpu_torch/csrc/*.cu`` compiled with
   nvcc for sm_90a into ``build/kernels/`` (ptxas register/smem report).
3. kernel  -- ``greedy_nms`` (CUDA) against ``greedy_nms_plain`` on the card
   over the listed cases: ``keep`` identical, boxes within rtol=1e-4,
   atol=1e-3 on all rows; then timings at B=1 and B=256, K=300: the
   kernel's device time (CUDA events) and host-inclusive time per call; the
   plain version's host-inclusive time (a Python loop of ~1200 launches).
4. fp32    -- YOLOv5s-640, 80 classes, B=2, f32 with TF32 off: head maps on
   the card against the CPU on the same seeded weights; the card's decoded
   candidates through the kernel and the plain version.
5. serving -- ``make_predict_step`` on YOLOv5s-640, 80 classes, bf16, /255
   folded into the stem, uint8 input: 3 batches at B=1 and 3 at B=64 after
   one warm-up each.  Launch counts are zeroed just before and read just
   after; every batch must launch the NMS kernel once.
6. (``--profile``) torch.profiler over one B=64 serving batch: device time
   by kernel and the device-busy share.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
Without CUDA it prints nothing to stdout and exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.ops import anchors as anchor_lib
from objectdetectionpl_tpu_torch.ops import nms
from objectdetectionpl_tpu_torch.ops.cuda import _build, nms_kernel
from objectdetectionpl_tpu_torch.train.step import (make_postprocess,
                                                    make_predict_step)
from objectdetectionpl_tpu_torch.utils.fuse import fold_input_scale

NUM_CLASSES = 80
IMG = 640
TOP_K = 300
BOX_TOL = dict(rtol=1e-4, atol=1e-3)
HEAD_TOL = dict(rtol=1e-3, atol=1e-3)    # f32 card vs CPU, 60 convs deep

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, non-tensor f32 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# greedy_nms work, counted from the candidates: one IoU test per valid pair
# i < j (4 min/max, 2x(sub, add, max), mul, add, sub, add, div, compare =
# 16 ops); per valid row its area (5) and its share of a merge (4 mul, 5 add).
IOU_PAIR_OPS = 16
ROW_OPS = 14
# bytes each row must move: boxes, score, label, obj in; boxes, keep out.
ROW_BYTES = 16 + 4 + 4 + 4 + 16 + 1
# torch.cuda._sleep spins in clock cycles; 2 GHz is above the H100's boost
# clock, so a spin of ms * this lasts at least ms.
SPIN_CYCLES_PER_MS = 2_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nms_bound_ms(scores: torch.Tensor) -> tuple:
    valid = (scores > nms_kernel.NEG_INF).sum(dim=1).double()
    ops = float((valid * (valid - 1) / 2).sum()) * IOU_PAIR_OPS \
        + float(valid.sum()) * ROW_OPS
    nbytes = scores.numel() * ROW_BYTES
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def call_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Host-inclusive ms per call: ``reps`` calls between synchronizes."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_ms(fn, reps: int) -> tuple:
    """(device ms per call, host-inclusive ms per call) of a function that
    launches a few kernels.

    For the device time the calls are queued behind a spin kernel long
    enough to hide the host's enqueue cost, so CUDA events see the device
    work alone; the run is repeated with a longer spin if the spin ended
    before the queue was full.
    """
    call_ms = call_time_ms(fn, reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_ms = 2.0 * call_ms * reps + 5.0
    for _ in range(4):
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps, call_ms
        spin_ms *= 4
    raise RuntimeError("could not queue the timed calls behind the spin")


def candidates(B, K, seed, classes=5, dense=False, n_invalid=10):
    """Score-sorted NMS candidates made on the CPU from a seed, on the card."""
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, K, generator=g)
    cx, cy, w, h = u(50, 550), u(50, 550), u(20, 120), u(20, 120)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if dense:                   # small coordinate range: long chains
        boxes /= 4.0
    scores = torch.rand(B, K, generator=g).sort(dim=1, descending=True).values
    scores[:, K - n_invalid:] = nms_kernel.NEG_INF
    labels = torch.randint(0, classes, (B, K), generator=g, dtype=torch.int32)
    obj = torch.where(scores > nms_kernel.NEG_INF,
                      torch.rand(B, K, generator=g), 0.0)
    return [t.contiguous().cuda() for t in (boxes, scores, labels, obj)]


def check_kernel(args, class_aware, merge) -> float:
    """Kernel vs plain on the same CUDA tensors; returns max |box error|."""
    kb, kk = nms_kernel.greedy_nms(*args, class_aware=class_aware,
                                   merge=merge)
    pb, pk = nms_kernel.greedy_nms_plain(*args, class_aware=class_aware,
                                         merge=merge)
    torch.cuda.synchronize()
    if not torch.equal(kk, pk):
        raise AssertionError(f"keep differs in {int((kk != pk).sum())} rows")
    torch.testing.assert_close(kb, pb, **BOX_TOL)
    return float((kb - pb).abs().max()) if kb.numel() else 0.0


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    info = {"phase": "device", "card": card,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    ptxas = [line.strip() for n in built
             for line in _build.build_log[n].splitlines()
             if "registers" in line or "spill" in line or "smem" in line]
    emit({"phase": "build", "seconds": secs, "built": built,
          "sources": _build.sources(), "ptxas": ptxas})


def phase_kernel(card: str) -> dict:
    both = ((True, True), (False, False))          # (class_aware, merge)
    cases = [
        ("random_B256_K300", candidates(256, 300, 1), both),
        ("random_B4_K37", candidates(4, 37, 2), both),
        ("dense_B8_K300", candidates(8, 300, 3, classes=3, dense=True), both),
        ("dense_B2_K1024", candidates(2, 1024, 4, dense=True), both[:1]),
        ("all_invalid_B2_K64", candidates(2, 64, 5, n_invalid=64), both[:1]),
        ("single_valid_B2_K64", candidates(2, 64, 6, n_invalid=63),
         both[:1]),
    ]
    max_err = 0.0
    for name, args, flag_pairs in cases:
        for class_aware, merge in flag_pairs:
            err = check_kernel(args, class_aware, merge)
            max_err = max(max_err, err)
            emit({"phase": "kernel_check", "case": name,
                  "class_aware": class_aware, "merge": merge,
                  "keep_equal": True, "max_abs_box_err": err})

    timing = {}
    for B in (1, 256):
        args = candidates(B, TOP_K, 10 + B)
        ms, call_ms = time_ms(lambda: nms_kernel.greedy_nms(*args), 200)
        plain_ms = call_time_ms(lambda: nms_kernel.greedy_nms_plain(*args),
                                20)
        bound_ms, bound_by = nms_bound_ms(args[1])
        timing[B] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "kernel_time", "B": B, "K": TOP_K, "card": card,
              **timing[B], "library_ms": None})
    return {"max_abs_err": max_err, "timing": timing}


def phase_fp32(card: str) -> float:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.rand(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    on_card = build_model("YOLOv5", NUM_CLASSES, device="cuda", seed=0)
    on_cpu = build_model("YOLOv5", NUM_CLASSES, device="cpu", seed=0)
    with torch.inference_mode():
        heads = on_card(x.cuda())
        ref = on_cpu(x)
    errs = []
    for h, r in zip(heads, ref):
        if not torch.isfinite(h).all():
            raise AssertionError("non-finite head map on the card")
        torch.testing.assert_close(h.cpu(), r, **HEAD_TOL)
        errs.append(float((h.cpu() - r).abs().max()))
    with torch.inference_mode():
        preds = nms.decode_yolov5_predictions(
            heads, anchor_lib.YOLOV5_ANCHORS, anchor_lib.YOLOV5_STRIDES,
            NUM_CLASSES)
        c = nms.yolo_candidates(preds, 0.5, TOP_K)
        err = check_kernel(c.nms_inputs(), True, True)
    n_valid = int((c.scores > nms.NEG_INF).sum())
    emit({"phase": "fp32_card_vs_cpu", "card": card, "B": 2, "img": IMG,
          "head_max_abs_err": errs, "head_tol": HEAD_TOL,
          "valid_candidates": n_valid, "keep_equal": True,
          "max_abs_box_err": err})
    return err


def serving_model():
    model = build_model("YOLOv5", NUM_CLASSES, dtype=torch.bfloat16,
                        device="cuda", seed=0)
    model.load_state_dict(fold_input_scale(model.state_dict(), 1.0 / 255.0))
    return make_predict_step(model, make_postprocess("YOLOv5", NUM_CLASSES,
                                                     IMG)), model


def phase_serving(card: str) -> dict:
    step, model = serving_model()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(0)
    batches = {B: torch.randint(0, 256, (B, IMG, IMG, 3), generator=g,
                                dtype=torch.uint8, device="cuda")
               for B in (1, 64)}
    torch.cuda.synchronize()
    nms_kernel.LAUNCHES = 0                    # main path starts here
    calls, results, last = 0, {}, None
    for B, images in batches.items():
        times = []
        for i in range(4):                     # one warm-up, three requests
            t0 = time.perf_counter()
            last = step(images)
            torch.cuda.synchronize()
            calls += 1
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        results[B] = {"ms_per_batch": times,
                      "img_per_s": [B * 1e3 / t for t in times]}
    launches = nms_kernel.LAUNCHES             # main path ends here
    if launches != calls:
        raise AssertionError(f"greedy_nms launched {launches} times in "
                             f"{calls} batches")
    for field, t in last._asdict().items():
        if not t.is_cuda:
            raise AssertionError(f"NMSResult.{field} is not on CUDA")
    if last.boxes.shape != (64, TOP_K, 4) or not torch.isfinite(
            last.boxes).all():
        raise AssertionError("serving boxes: wrong shape or non-finite")
    for B, r in results.items():
        emit({"phase": "serving", "card": card, "model": "Yolov5s",
              "img": IMG, "classes": NUM_CLASSES, "dtype": "bfloat16",
              "B": B, **r})
    # the last batch's candidates through kernel and plain version (bf16)
    with torch.inference_mode():
        preds = nms.decode_yolov5_predictions(
            model(batches[64]), anchor_lib.YOLOV5_ANCHORS,
            anchor_lib.YOLOV5_STRIDES, NUM_CLASSES)
        args = nms.yolo_candidates(preds, 0.5, TOP_K).nms_inputs()
        err = check_kernel(args, True, True)
        ms, call_ms = time_ms(lambda: nms_kernel.greedy_nms(*args), 100)
    bound_ms, bound_by = nms_bound_ms(args[1])
    emit({"phase": "serving_check", "card": card, "B": 64,
          "valid": int(last.valid.sum()), "keep_equal": True,
          "max_abs_box_err": err, "nms_ms": ms, "nms_call_ms": call_ms,
          "nms_bound_ms": bound_ms, "nms_bound_by": bound_by,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"launches": launches, "max_abs_err": err}


def phase_profile(card: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    step, _ = serving_model()
    images = torch.randint(0, 256, (64, IMG, IMG, 3), dtype=torch.uint8,
                           device="cuda")
    for _ in range(2):
        step(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    events.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    emit({"phase": "profile", "card": card, "B": 64, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "top": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                   "calls": e.count} for e in events[:20]]})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one B=64 serving batch")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    info = phase_device()
    card = info["card"]
    phase_build()
    kern = phase_kernel(card)
    fp32_err = phase_fp32(card)
    serve = phase_serving(card)
    if args.profile:
        phase_profile(card)
    t = kern["timing"]
    err = max(kern["max_abs_err"], fp32_err, serve["max_abs_err"])
    emit({"kernels": [{
        "name": "greedy_nms", "route": "cuda",
        "source": "objectdetectionpl_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "objectdetectionpl_tpu/ops/pallas/nms_kernel.py:120",
        "launches": serve["launches"], "keep_equal": True,
        "max_abs_err": err, "max_abs_box_err": err,
        "ms": t[256]["ms"], "plain_ms": t[256]["plain_ms"],
        "bound_ms": t[256]["bound_ms"], "bound_by": t[256]["bound_by"],
        "library_ms": None, "shape": "B=256,K=300",
        "call_ms": t[256]["call_ms"],
        "ms_b1": t[1]["ms"], "call_ms_b1": t[1]["call_ms"],
        "plain_ms_b1": t[1]["plain_ms"], "bound_ms_b1": t[1]["bound_ms"],
        "card": card}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
