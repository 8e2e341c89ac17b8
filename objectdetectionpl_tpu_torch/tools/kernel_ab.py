"""A/B tool for the greedy-NMS and affine-warp kernels on the card.

Run from a checkout's root:

    python3 -m objectdetectionpl_tpu_torch.tools.kernel_ab [--phases]

or, to measure another checkout's package (say an older commit unpacked
into ``build/parent``) with this tool:

    cd build/parent && PYTHONPATH=. python3 \\
        ../../objectdetectionpl_tpu_torch/tools/kernel_ab.py [--phases]

It prints one JSON line per measurement, each with the card's name and power
limit and the package it measured:

- ``nms_time``: ``greedy_nms`` device ms (CUDA events behind a spin kernel)
  on the seeded candidates of ``chip_smoke.py`` (B=1 and B=256, K=300, 5
  classes; B=64, K=300, 80 classes) and on the serving chain's (YOLOv5s-640
  bf16, random weights from seed 0, B=64 and its first image, at K=300 and
  at every decoded row, ``nms_top_k`` 25,200 and conf_thres 0.001), with
  the chain length of the greedy scan: kept heads per image, mean and max;
- ``warp_time``: the warp kernel at K=26 slots of 640x640x3, every slot
  warped (``all_used``) and the training mix from a seed (``mix``, about
  half the slots warped), and the SSR tail of ``augment_batch`` on a B=64
  batch from the slot gather (or the fused slot call) through
  ``index_copy_``;
- with ``--phases``: ``nms_phases``, the split of one launch of the
  package's ``csrc/greedy_nms.cu`` into its phases, read from ``clock64()``
  stamps that this tool adds to a copy of the source at the phase comments
  (``// 1.`` to ``// 4.`` and the kernel's closing brace) and builds under
  ``build/probe/``; cycles per block, mean and max over blocks, and the same
  at the card's largest SM clock in microseconds.  Where the source has
  the K > 1024 route's probe (``NMS_PROBE``), the same build also gives
  ``route_phases`` on the serving decode at ``nms_top_k`` 25,200
  (conf_thres 0.001, B=1 and 64) and on seeded candidates of 80 labels
  and of one label (B=1): the partition kernel's span and the segment
  kernel's (globaltimer, us), the segment CTAs' cycles in each phase
  (waiting for a ticket, staging rows, the chain, the merge and outputs,
  the drop pass) summed and per CTA, the items each CTA took, and the
  segments by size.

The package measured is the one ``import objectdetectionpl_tpu_torch``
finds; the tool uses only what both the older and the newer wrappers have,
and takes the fused slot call where the package has it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

import objectdetectionpl_tpu_torch as pkg
from objectdetectionpl_tpu_torch.data import augment
from objectdetectionpl_tpu_torch.ops.cuda import _build, nms_kernel, warp_kernel
from objectdetectionpl_tpu_torch.utils import timing

TOP_K = 300
IMG = 640
WARP_K = 26              # warp slots at B=64: round(64 * 2 * p_ssr)
TRAIN_B = 64
NMS_REPS = 200
WIDE_REPS = 20           # launches timed above K=1024 (ms each, not us)
SERVE_ALL_K = 25200      # every decoded row of YOLOv5s-640 into the NMS
SERVE_ALL_CONF = 0.001   # as an mAP evaluation runs
PHASES = ("stage", "relation", "scan", "merge")


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


def serving_candidates(B: int = 64, conf_thres: float = 0.5,
                       top_k: int = TOP_K) -> list:
    """The NMS inputs of one B-image serving batch of YOLOv5s-640 bf16, 80
    classes, random weights from seed 0, uint8 images from seed 0."""
    from objectdetectionpl_tpu_torch.models import build_model
    from objectdetectionpl_tpu_torch.ops import anchors, nms
    from objectdetectionpl_tpu_torch.utils.fuse import fold_input_scale
    model = build_model("YOLOv5", 80, dtype=torch.bfloat16, device="cuda",
                        seed=0)
    model.load_state_dict(fold_input_scale(model.state_dict(), 1.0 / 255.0))
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (B, IMG, IMG, 3), generator=g,
                           dtype=torch.uint8, device="cuda")
    with torch.inference_mode():
        preds = nms.decode_yolov5_predictions(
            model(images), anchors.YOLOV5_ANCHORS, anchors.YOLOV5_STRIDES, 80)
        return list(nms.yolo_candidates(preds, conf_thres,
                                        top_k).nms_inputs())


def nms_cases() -> dict:
    serve = serving_candidates()
    every = serving_candidates(64, SERVE_ALL_CONF, SERVE_ALL_K)
    return {"random_B1_C5": candidates(1, TOP_K, 11),
            "random_B256_C5": candidates(256, TOP_K, 266),
            "random_B64_C80": candidates(64, TOP_K, 74, classes=80),
            "serving_B64": serve,
            "serving_B1": [t[:1].contiguous() for t in serve],
            "serving_all_B64": every,
            "serving_all_B1": [t[:1].contiguous() for t in every]}


def chain_length(args, **flags) -> dict:
    """Kept heads per image of the greedy scan, mean and max; ``flags``
    go to ``greedy_nms``."""
    _, keep = nms_kernel.greedy_nms(*args, **flags)
    kept = keep.sum(dim=1).float()
    return {"chain_mean": float(kept.mean()), "chain_max": int(kept.max())}


def ssr_inverses(K: int, seed: int) -> torch.Tensor:
    """Inverse matrices of K random shift-scale-rotate draws inside the
    ``AugmentConfig`` bounds (every coin selects SSR)."""
    u = torch.rand(K, 14, generator=torch.Generator().manual_seed(seed))
    u[:, 2] = 0.0
    fwd, _ = augment._ssr_params(u, augment.AugmentConfig())
    return torch.linalg.inv(fwd)


def ssr_mix(B: int, K: int, seed: int) -> tuple:
    """(top [K] int64, inv [K, 3, 3], use [K] bool) on the card as
    ``augment_batch`` forms them from a seeded [B, 14] draw: the K smallest
    SSR coins in coin order (not sorted by index), their inverse matrices,
    and whether each coin selected SSR (about half of the K)."""
    u = torch.rand(B, 14, generator=torch.Generator().manual_seed(seed))
    cfg = augment.AugmentConfig()
    top = torch.sort(u[:, 2], stable=True).indices[:K]
    fwd, do = augment._ssr_params(u, cfg)
    fwd = torch.where(do[:, None, None], fwd, torch.eye(3)[None])
    inv = torch.linalg.inv(fwd[top])
    return top.cuda(), inv.contiguous().cuda(), do[top].cuda()


def fused() -> bool:
    """Whether the package warps slots in one call (gather and select
    inside the kernel)."""
    return hasattr(warp_kernel, "affine_warp_slots")


def warp_slots(images, top, inv, use):
    """``use[k] ? warp(images[top[k]], inv[k]) : images[top[k]]`` through
    the package's own path."""
    if fused():
        return warp_kernel.affine_warp_slots(images, top, inv, use)
    slots = images[top]
    warped = warp_kernel.affine_warp(slots, inv)
    return torch.where(use[:, None, None, None], warped, slots)


def warp_inputs() -> dict:
    """The timed warp's inputs on the card: a B=64 batch of 640x640x3
    images from seed 23; ``top``, ``inv`` and ``use`` of the training mix
    from seed 25; ``inv_all`` from seed 24 with every slot warped."""
    g = torch.Generator().manual_seed(23)
    batch = torch.rand(TRAIN_B, IMG, IMG, 3, generator=g).cuda()
    top, inv, use = ssr_mix(TRAIN_B, WARP_K, 25)
    return {"batch": batch, "top": top, "inv": inv, "use": use,
            "inv_all": ssr_inverses(WARP_K, 24).contiguous().cuda(),
            "all_used": torch.ones(WARP_K, dtype=torch.bool, device="cuda")}


def warp_times(w: dict) -> dict:
    """Device ms of the warp kernel, every slot warped and the training
    mix, and of the SSR tail through ``index_copy_`` (which changes
    ``w["batch"]``)."""
    batch, top = w["batch"], w["top"]
    if fused():
        run = {"all_used": lambda: warp_kernel.affine_warp_slots(
                   batch, top, w["inv_all"], w["all_used"]),
               "mix": lambda: warp_kernel.affine_warp_slots(
                   batch, top, w["inv"], w["use"])}
    else:                        # the kernel warps every slot it is given
        slots = batch[top].contiguous()
        run = {"all_used": lambda: warp_kernel.affine_warp(slots,
                                                           w["inv_all"]),
               "mix": lambda: warp_kernel.affine_warp(slots, w["inv"])}
    out = {"fused": fused(), "K": WARP_K, "used": int(w["use"].sum())}
    for name, fn in run.items():
        out[name + "_ms"], out[name + "_call_ms"] = timing.time_ms(fn, 200)
    tail = lambda: batch.index_copy_(0, top, warp_slots(batch, top, w["inv"],
                                                        w["use"]))
    # a few launches a call: 40 calls stay inside the launch queue's depth
    out["tail_ms"], out["tail_call_ms"] = timing.time_ms(tail, 40)
    return out


# --- the NMS kernel's phases ------------------------------------------------

_STAMPS = """#include <cuda_runtime.h>
__device__ long long g_phase_clk[5 * 4096];
#define PHASE_STAMP(n) do { __syncthreads(); \\
  if (threadIdx.x == 0 && blockIdx.x < 4096) \\
    g_phase_clk[blockIdx.x * 5 + (n)] = clock64(); } while (0)
"""
_READERS = """
extern "C" int phase_clocks(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_phase_clk, n * sizeof(long long));
}
extern "C" int sm_clock_khz() {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrClockRate, 0);
  return v;
}
"""


def instrument(source: str) -> str:
    """The source with a stamp before each phase comment and before the
    kernel's closing brace (the first line that is ``}`` after phase 4)."""
    out, stage = [], 0
    for line in source.splitlines():
        if stage < 4 and line.strip().startswith(f"// {stage + 1}."):
            out.append(f"  PHASE_STAMP({stage});")
            stage += 1
        elif stage == 4 and line == "}":
            out.append("  PHASE_STAMP(4);")
            stage += 1
        out.append(line)
    if stage != 5:
        raise ValueError(f"found {stage} of the 5 phase marks")
    return _STAMPS + "\n".join(out) + "\n" + _READERS


def probe_lib(source: Path) -> ctypes.CDLL:
    text = instrument(source.read_text())
    route = "NMS_PROBE" in text                # the K > 1024 route's stamps
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    probe = _build.BUILD_DIR.parent / "probe"
    probe.mkdir(parents=True, exist_ok=True)
    cu, lib = probe / f"nms_phases-{digest}.cu", probe / f"nms_phases-{digest}.so"
    if not lib.exists():
        cu.write_text(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        *(["-DNMS_PROBE"] if route else []), "-o", str(lib),
                        str(cu)], check=True, capture_output=True, text=True,
                       timeout=_build.BUILD_TIMEOUT_S)
    dll = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    dll.greedy_nms_launch.argtypes = [
        p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, p, ctypes.c_int, p]
    dll.phase_clocks.argtypes = [p, ctypes.c_int]
    if route:
        dll.route_probe.argtypes = [p, p, p, ctypes.c_int]
        dll.greedy_nms_workspace_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        dll.greedy_nms_workspace_bytes.restype = ctypes.c_size_t
    dll.route = route
    return dll


ROUTE_PHASES = ("wait", "stage", "cross", "chain", "merge", "drop")  # ProbePhase
PROBE_CTAS = 4096


def route_cases(cases: dict) -> dict:
    """The K > 1024 route's cases: the serving decode of ``nms_cases`` at
    nms_top_k 25,200 (B=64 and its first image) and seeded candidates of
    80 labels and of one label."""
    c1 = candidates(1, SERVE_ALL_K, 25201)
    c1[2].zero_()
    return {"serving_all_B1": cases["serving_all_B1"],
            "serving_all_B64": cases["serving_all_B64"],
            "random_B1_K25200_C80": candidates(1, SERVE_ALL_K, 25280,
                                               classes=80),
            "random_B1_K25200_C1": c1}


def route_phases(dll: ctypes.CDLL, args) -> dict:
    """One launch of the K > 1024 route with the probe's stamps, after two
    warm launches; the segments' sizes from the candidates' labels."""
    boxes, scores, labels, obj = args
    B, K = scores.shape
    out = torch.empty_like(boxes)
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    ws = torch.empty(dll.greedy_nms_workspace_bytes(B, K), dtype=torch.uint8,
                     device=boxes.device)
    launch = lambda: dll.greedy_nms_launch(
        boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
        obj.data_ptr(), out.data_ptr(), keep.data_ptr(), B, K, 0.4, 1, 1,
        1.0, torch.cuda.current_stream().cuda_stream, 0, ws.data_ptr())
    for i in range(3):
        if i == 2:
            torch.cuda.synchronize()
            if dll.route_probe_clear():
                raise RuntimeError("could not clear the route probe")
        if launch():
            raise RuntimeError("probe launch failed")
    torch.cuda.synchronize()
    n = PROBE_CTAS
    part = (ctypes.c_longlong * (2 * n))()
    seg = (ctypes.c_longlong * (2 * n))()
    clk = (ctypes.c_longlong * (8 * n))()
    if dll.route_probe(ctypes.addressof(part), ctypes.addressof(seg),
                       ctypes.addressof(clk), n):
        raise RuntimeError("could not read the route probe")
    part = torch.tensor(list(part), dtype=torch.float64).view(n, 2)[:B]
    seg = torch.tensor(list(seg), dtype=torch.float64).view(n, 2)
    ran = seg[:, 0] > 0
    clk = torch.tensor(list(clk), dtype=torch.float64).view(n, 8)[ran]
    seg = seg[ran]
    khz = dll.sm_clock_khz()
    valid = scores > nms_kernel.NEG_INF
    lab = labels.long() - int(labels[valid].min())
    key = torch.arange(B, device=labels.device)[:, None] * (
        int(lab[valid].max()) + 1) + lab
    sizes = torch.bincount(key[valid])
    sizes = sizes[sizes > 0].sort(descending=True).values.cpu()
    res = {"keep_equal_to_kernel": torch.equal(
               keep, nms_kernel.greedy_nms(*args)[1]),
           "sm_clock_mhz": khz / 1e3,
           "partition_us": float(part[:, 1].max() - part[:, 0].min()) / 1e3,
           "segment_kernel_us": float(seg[:, 1].max() - seg[:, 0].min()) / 1e3,
           "ctas": int(ran.sum()), "segments": len(sizes),
           "items_per_cta_max": int(clk[:, len(ROUTE_PHASES)].max()),
           "largest_segments": sizes[:8].tolist(),
           "segment_rows_mean": float(sizes.double().mean())}
    for i, name in enumerate(ROUTE_PHASES):
        c = clk[:, i]
        res[name] = {"cycles_sum": float(c.sum()),
                     "cycles_max_cta": float(c.max()),
                     "us_max_cta_at_max_clock": float(c.max()) / khz * 1e3}
    return res


def phases(dll: ctypes.CDLL, args) -> dict:
    boxes, scores, labels, obj = args
    B, K = scores.shape
    if B > 4096:
        raise ValueError("the probe stamps at most 4096 blocks")
    out = torch.empty_like(boxes)
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    launch = lambda: dll.greedy_nms_launch(
        boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
        obj.data_ptr(), out.data_ptr(), keep.data_ptr(), B, K, 0.4, 1, 1,
        1.0, torch.cuda.current_stream().cuda_stream, 0, None)
    for _ in range(3):                         # warm: the last launch counts
        if launch():
            raise RuntimeError("probe launch failed")
    torch.cuda.synchronize()
    clk = (ctypes.c_longlong * (5 * B))()
    if dll.phase_clocks(ctypes.addressof(clk), 5 * B):
        raise RuntimeError("could not read the phase clocks")
    stamps = torch.tensor(list(clk), dtype=torch.float64).view(B, 5)
    cycles = stamps.diff(dim=1)                # [B, 4]
    khz = dll.sm_clock_khz()
    res = {"sm_clock_mhz": khz / 1e3, "keep_equal_to_kernel": torch.equal(
        keep, nms_kernel.greedy_nms(*args)[1])}
    for i, name in enumerate(PHASES + ("total",)):
        c = cycles[:, i] if i < 4 else cycles.sum(dim=1)
        res[name] = {"cycles_mean": float(c.mean()),
                     "cycles_max": float(c.max()),
                     "us_mean_at_max_clock": float(c.mean()) / khz * 1e3}
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", action="store_true",
                        help="also split one NMS launch into its phases")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = timing.card()
    where = str(Path(pkg.__file__).resolve().parent)
    emit = lambda d: print(json.dumps({**d, "card": card, "package": where}),
                           flush=True)
    _build.build(["greedy_nms", "affine_warp"])
    cases = nms_cases()
    for name, a in cases.items():
        ms, call_ms = timing.time_ms(lambda: nms_kernel.greedy_nms(*a),
                                     NMS_REPS if a[1].shape[1] <= TOP_K
                                     else WIDE_REPS)
        emit({"phase": "nms_time", "case": name, "B": a[1].shape[0],
              "K": a[1].shape[1], "ms": ms, "call_ms": call_ms,
              **chain_length(a)})
    emit({"phase": "warp_time", **warp_times(warp_inputs())})
    if args.phases:
        dll = probe_lib(_build.CSRC / "greedy_nms.cu")
        for name, a in cases.items():
            if a[1].shape[1] <= TOP_K:         # the single-tile kernel
                emit({"phase": "nms_phases", "case": name,
                      "B": a[1].shape[0], **phases(dll, a)})
        if dll.route:
            for name, a in route_cases(cases).items():
                emit({"phase": "route_phases", "case": name,
                      "B": a[1].shape[0], "K": a[1].shape[1],
                      **route_phases(dll, a)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
