"""Greedy weighted-merge NMS: the Hopper kernel ``csrc/greedy_nms.cu`` and its
plain PyTorch version.

The counterpart of ``objectdetectionpl_tpu/ops/pallas/nms_kernel.py``
(``pallas_greedy_nms``) and of the XLA ``blocked_greedy_nms`` in
``objectdetectionpl_tpu/ops/nms.py``: all three compute the same function.

:func:`greedy_nms` calls the custom op ``objdet::greedy_nms``
(``torch.library``), whose CPU kernel is the plain version and whose CUDA
kernel launches ``csrc/greedy_nms.cu`` or raises; ``LAUNCHES`` counts the
launches, so a run can show that its path went through the kernel, and
``TILED_LAUNCHES`` those of them that took the route for K above
``greedy_nms_max_k()`` (1024): a partition kernel that splits each image's
valid rows by label and a segment kernel that runs each (image, label)
segment's chain, with a device workspace that the CUDA implementation
allocates on the tensors' card.  :func:`greedy_nms_segmented_plain` is
that route's function in plain PyTorch, for the tests and the card's
checks.  The
op's fake kernel gives the output shapes, so ``torch.export`` captures the
op as one node of the serving graph (``utils/export.py``), and a program
loaded from a ``.pt2`` file calls the same kernels once this module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from objectdetectionpl_tpu_torch.ops.cuda import _build

NEG_INF = -1e9

LAUNCHES = 0          # kernel launches by greedy_nms since import (or reset)
TILED_LAUNCHES = 0    # those of them at K > greedy_nms_max_k(): the split route
# greedy_nms_segmented_plain: relation entries ([n, n] a segment) a call
SEGMENT_PAIRS_PER_CALL = 1 << 24

# The split route's workspace header (int32 words, greedy_nms_workspace_bytes)
HEADER_ONE_SEGMENT = 33   # images whose label range exceeded the histogram
HEADER_SEGMENTS = 34      # segments the partition listed


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("greedy_nms")
    p = ctypes.c_void_p
    lib.greedy_nms_launch.argtypes = [
        p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, p, ctypes.c_int, p]
    lib.greedy_nms_launch.restype = ctypes.c_int
    lib.greedy_nms_max_k.argtypes = []
    lib.greedy_nms_max_k.restype = ctypes.c_int
    lib.greedy_nms_label_bins.argtypes = []
    lib.greedy_nms_label_bins.restype = ctypes.c_int
    lib.greedy_nms_workspace_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.greedy_nms_workspace_bytes.restype = ctypes.c_size_t
    lib.greedy_nms_tiled_launch.argtypes = lib.greedy_nms_launch.argtypes
    lib.greedy_nms_tiled_launch.restype = ctypes.c_int
    return lib


def greedy_nms_plain(boxes, scores, labels, obj, nms_thresh: float = 0.4,
                     class_aware: bool = True, merge: bool = True,
                     plus1: float = 1.0, drop_lone_survivor: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy NMS in plain PyTorch, on any device.

    boxes [B, K, 4] xyxy sorted by descending score; scores [B, K]
    (<= -1e9 invalid); labels [B, K]; obj [B, K] merge weights.  Returns
    (boxes [B, K, 4] f32, keep [B, K] bool); with ``merge`` each kept box is
    the obj-weighted mean of itself and the boxes it was first to suppress,
    every other row is returned as given.  ``drop_lone_survivor`` un-keeps
    each image's last kept row k unless some valid j > k has k as its
    first kept suppressor (before the merge).  Same arithmetic as
    ``blocked_greedy_nms``: K x K relation, a serial sweep over K columns,
    then first-kept-suppressor attribution.
    """
    B, K, _ = boxes.shape
    boxes = boxes.float()
    valid = scores.float() > NEG_INF
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + plus1) * (y2 - y1 + plus1)
    inter_w = (torch.minimum(x2[:, :, None], x2[:, None, :])
               - torch.maximum(x1[:, :, None], x1[:, None, :]) + plus1)
    inter_h = (torch.minimum(y2[:, :, None], y2[:, None, :])
               - torch.maximum(y1[:, :, None], y1[:, None, :]) + plus1)
    inter = inter_w.clamp(min=0.0) * inter_h.clamp(min=0.0)
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-16)
    over = iou > nms_thresh                     # compared in f32
    if class_aware:
        over &= labels[:, :, None] == labels[:, None, :]
    over &= torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    over &= valid[:, :, None] & valid[:, None, :]

    keep = torch.zeros(B, K, dtype=torch.bool, device=boxes.device)
    suppressed = torch.zeros_like(keep)
    for i in range(K):
        kept = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = kept
        suppressed |= kept[:, None] & over[:, i]
    ids = torch.arange(K, device=boxes.device)

    def first_suppressor():                     # [B, K]; K = none
        return torch.where(keep[:, :, None] & over, ids[:, None],
                           K).amin(dim=1)

    if drop_lone_survivor:
        first = first_suppressor()
        last_kept = (K - 1) - keep.flip(1).int().argmax(dim=1)   # [B]
        late = ((ids[None, :] > last_kept[:, None]) & valid
                & (first >= last_kept[:, None])).any(dim=1)
        drop = keep.any(dim=1) & ~late
        keep = keep & ~(drop[:, None] & (ids[None, :] == last_kept[:, None]))
    if not merge:
        return boxes.clone(), keep

    first = first_suppressor()
    w = torch.where(valid, obj.float(), 0.0)
    num = torch.zeros(B, K + 1, 4, device=boxes.device).scatter_add_(
        1, first[..., None].expand(B, K, 4), w[..., None] * boxes)
    den = torch.zeros(B, K + 1, device=boxes.device).scatter_add_(1, first, w)
    num = num[:, :K] + w[..., None] * boxes
    den = den[:, :K] + w
    merged = num / den.clamp(min=1e-16)[..., None]
    return torch.where(keep[..., None], merged, boxes), keep


def greedy_nms_segmented_plain(boxes, scores, labels, obj,
                               nms_thresh: float = 0.4,
                               class_aware: bool = True, merge: bool = True,
                               plus1: float = 1.0,
                               drop_lone_survivor: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`greedy_nms_plain`'s function computed as the K > 1024 route
    computes it: each image's valid rows split into segments by label
    (class-aware; one segment of all valid rows otherwise), each segment
    through :func:`greedy_nms_plain` on its rows in ascending order, the
    results scattered back, then ``drop_lone_survivor`` for the image: its
    last kept row, over all segments, un-kept (and given its input box
    back) when its group is empty.  Segments of similar size are padded
    with invalid rows and taken together, ``SEGMENT_PAIRS_PER_CALL``
    relation entries a call.  Not on any serving path: the tests and the
    card's checks hold the kernels and ``greedy_nms_plain`` against it."""
    B, K, _ = boxes.shape
    dev = boxes.device
    boxes = boxes.float()
    valid = scores.float() > NEG_INF
    out = boxes.clone()
    keep = torch.zeros(B, K, dtype=torch.bool, device=dev)
    b_idx, r_idx = valid.nonzero(as_tuple=True)       # rows ascending
    if not len(b_idx):
        return out, keep
    key = labels[b_idx, r_idx].long() if class_aware else \
        torch.zeros_like(b_idx)
    key = key - key.min()
    seg_of = b_idx * (int(key.max()) + 1) + key
    order = torch.sort(seg_of, stable=True).indices
    seg_ids, sizes = torch.unique_consecutive(seg_of[order],
                                              return_counts=True)
    starts = torch.cumsum(sizes, 0) - sizes
    by_size = torch.argsort(sizes, descending=True).tolist()
    sizes_l, starts_l = sizes.tolist(), starts.tolist()
    last_lone = {}                  # segment -> (its last kept row, lone)
    at = 0
    while at < len(by_size):
        n = sizes_l[by_size[at]]
        take = max(1, SEGMENT_PAIRS_PER_CALL // (n * n))
        group = by_size[at:at + take]
        at += len(group)
        pos = torch.full((len(group), n), -1, dtype=torch.long, device=dev)
        for g, s in enumerate(group):
            pos[g, :sizes_l[s]] = order[starts_l[s]:starts_l[s] + sizes_l[s]]
        pad = pos < 0
        rows = pos.clamp(min=0)
        bb, rr = b_idx[rows], r_idx[rows]
        args = (torch.where(pad[..., None], 0.0, boxes[bb, rr]),
                torch.where(pad, NEG_INF, scores.float()[bb, rr]),
                labels[bb, rr], torch.where(pad, 0.0, obj.float()[bb, rr]))
        flags = dict(nms_thresh=nms_thresh, class_aware=class_aware,
                     plus1=plus1)
        sb, sk = greedy_nms_plain(*args, merge=merge, **flags)
        live = ~pad
        out[bb[live], rr[live]] = sb[live]
        keep[bb[live], rr[live]] = sk[live]
        if drop_lone_survivor:
            _, dk = greedy_nms_plain(*args, merge=False,
                                     drop_lone_survivor=True, **flags)
            for g, s in enumerate(group):
                kept = sk[g].nonzero()
                if len(kept):
                    j = int(kept[-1])
                    last_lone[s] = (int(rr[g, j]), bool(not dk[g, j]))
    if drop_lone_survivor:
        seg_image = (seg_ids // (int(key.max()) + 1)).tolist()
        for b in range(B):
            ends = [v for s, v in last_lone.items() if seg_image[s] == b]
            if ends:
                row, lone = max(ends)
                if lone:
                    keep[b, row] = False
                    out[b, row] = boxes[b, row]
    return out, keep


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"greedy_nms: {name} is on {t.device}, boxes on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"greedy_nms: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"greedy_nms: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"greedy_nms: {name} must be contiguous")


def greedy_nms(boxes, scores, labels, obj, nms_thresh: float = 0.4,
               class_aware: bool = True, merge: bool = True,
               plus1: float = 1.0, drop_lone_survivor: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy NMS; see :func:`greedy_nms_plain` for the contract.

    CPU tensors go to the plain version.  CUDA tensors must be contiguous,
    boxes/scores/obj float32 and labels int32; any K: up to 1024 one
    kernel holds the image's relation in shared memory, above it a
    partition kernel splits the valid rows by label and a segment kernel
    runs each segment's chain (one tile of 1024 rows, or tiles).  The
    kernels run on the current stream.  Either way through the op ``objdet::greedy_nms``;
    other devices raise.
    """
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"greedy_nms: unsupported device {boxes.device}")
    return torch.ops.objdet.greedy_nms(
        boxes, scores, labels, obj, float(nms_thresh), bool(class_aware),
        bool(merge), float(plus1), bool(drop_lone_survivor))


@torch.library.custom_op("objdet::greedy_nms", mutates_args=(),
                         device_types="cpu")
def _greedy_nms_op(boxes: torch.Tensor, scores: torch.Tensor,
                    labels: torch.Tensor, obj: torch.Tensor,
                    nms_thresh: float, class_aware: bool, merge: bool,
                    plus1: float, drop_lone_survivor: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    return greedy_nms_plain(boxes, scores, labels, obj, nms_thresh,
                            class_aware, merge, plus1, drop_lone_survivor)


@_greedy_nms_op.register_kernel("cuda")
def _greedy_nms_cuda(boxes, scores, labels, obj, nms_thresh, class_aware,
                     merge, plus1, drop_lone_survivor):
    B, K = scores.shape
    dev = boxes.device
    _check(boxes, "boxes", torch.float32, (B, K, 4), dev)
    _check(scores, "scores", torch.float32, (B, K), dev)
    _check(labels, "labels", torch.int32, (B, K), dev)
    _check(obj, "obj", torch.float32, (B, K), dev)
    if boxes.data_ptr() % 16:
        raise ValueError("greedy_nms: boxes must be 16-byte aligned")
    lib = _lib()
    out = torch.empty_like(boxes)
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    if B == 0 or K == 0:
        return out, keep
    tiled = K > lib.greedy_nms_max_k()
    # the split route's segments, work list and per-head sums
    workspace = (torch.empty(lib.greedy_nms_workspace_bytes(B, K),
                             dtype=torch.uint8, device=dev) if tiled else None)
    # the launch and its shared-memory attribute act on the current
    # device: make it the tensors' card
    with torch.cuda.device(dev):
        err = lib.greedy_nms_launch(
            boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
            obj.data_ptr(), out.data_ptr(), keep.data_ptr(), B, K,
            float(nms_thresh), int(class_aware), int(merge), float(plus1),
            torch.cuda.current_stream(dev).cuda_stream,
            int(drop_lone_survivor),
            None if workspace is None else workspace.data_ptr())
    if err != 0:
        raise RuntimeError(f"greedy_nms kernel launch failed: cudaError {err}")
    global LAUNCHES, TILED_LAUNCHES
    LAUNCHES += 1
    TILED_LAUNCHES += int(tiled)
    return out, keep


@_greedy_nms_op.register_fake
def _greedy_nms_fake(boxes, scores, labels, obj, nms_thresh, class_aware,
                     merge, plus1, drop_lone_survivor):
    return (torch.empty_like(boxes, dtype=torch.float32),
            boxes.new_empty(scores.shape, dtype=torch.bool))
