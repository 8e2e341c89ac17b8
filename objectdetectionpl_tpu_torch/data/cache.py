"""Packed pre-decoded dataset cache: one uint8 memmap of resized images.

The port of ``objectdetectionpl_tpu/data/cache.py``, same layout, names and
files.  One pass through a parser writes every image, already resized (or
letterboxed) to the training size, into a uint8 memmap, with the
normalized targets; after it a Loader epoch is a gather of rows, with no
decode and no resize.

Layout under ``cache_dir``::

    images.u8    raw memmap [N, S, S, 3] uint8 (post-resize, RGB)
    targets.npz  boxes [T,4] f32 normalized center xywh, labels [T] i32,
                 offsets [N+1] i64 (ragged row spans)
    meta.json    {"n", "img_size", "letterbox", "version", "exif"}

The images are read as JAX fills its cache, by ``cv2.imread`` (turned by
their EXIF orientation) and cv2's INTER_LINEAR on uint8 (the host
library's uint8 resize, else ``pipeline.resize_u8``), so the two caches
are equal byte for byte.  A parser with ``record(i)`` is
read with ``native.decode_preproc_codes`` straight into the memmap's
rows, ``BUILD_CHUNK`` images a call, as cv2 reads JPEG (CMYK and YCCK
too); a file that call does not read (a PNG or a BMP, whatever its name)
goes through ``native.decode_image`` and the uint8 resize, and one that
neither reads raises ``native.ImageError`` naming it.  Batches stay uint8 and the Trainer
divides by 255 on the device (``train/loop.py``).

``"exif": true`` in ``meta.json`` marks a cache whose images were turned
by their EXIF orientation.  JAX's caches and the port's older ones lack
it (JAX ignores the key): :func:`build_packed_cache` rebuilds such a
directory once, since an older port cache may hold unturned images, while
a Loader given the directory reads it as JAX's Loader does.
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Optional

import numpy as np

from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.pipeline import (box_targets,
                                                       numpy_preproc_u8)
from objectdetectionpl_tpu_torch.data.types import Batch, pad_targets

_VERSION = 1
BUILD_CHUNK = 64          # images per resize call while building


def cache_valid(cache_dir: str, n: int, img_size: int,
                letterbox: bool, exif: bool = True) -> bool:
    """True if ``cache_dir`` holds a complete cache matching the request;
    with ``exif``, one marked as turned by the EXIF orientation."""
    meta_path = os.path.join(cache_dir, "meta.json")
    if not os.path.exists(meta_path):
        return False
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    return (meta.get("version") == _VERSION and meta.get("n") == n
            and meta.get("img_size") == img_size
            and bool(meta.get("letterbox")) == bool(letterbox)
            and (meta.get("exif") is True or not exif)
            and os.path.exists(os.path.join(cache_dir, "images.u8"))
            and os.path.exists(os.path.join(cache_dir, "targets.npz")))


def _resize_chunk(parser, idx: range, S: int, letterbox: bool,
                  out: np.ndarray):
    """Images ``idx`` of ``parser`` resized into ``out`` (uint8): (boxes
    px, labels, ws, hs, scales, pad_xs, pad_ys) of each."""
    if hasattr(parser, "record"):
        recs = [parser.record(i) for i in idx]
        # full scale and turned by the EXIF orientation, as the JAX
        # package's cv2.imread: the boxes are normalised by the turned sizes
        _, ws, hs, scales, pad_xs, pad_ys, codes = native.decode_preproc_codes(
            [r[0] for r in recs], S, letterbox, out, u8=True, max_denom=1,
            exif=True, imread=True)
        for i in np.flatnonzero(codes):
            img = native.decode_image(recs[i][0], exif=True)
            hs[i], ws[i] = img.shape[:2]
            _, scales[i:i + 1], pad_xs[i:i + 1], pad_ys[i:i + 1] = (
                native.preproc_batch([img], S, letterbox, out[i:i + 1],
                                     u8=True))
        return ([r[1] for r in recs], [r[2] for r in recs], ws, hs, scales,
                pad_xs, pad_ys)
    examples = [parser[i] for i in idx]
    images = [ex.image for ex in examples]
    if native.available():
        _, scales, pad_xs, pad_ys = native.preproc_batch(images, S, letterbox,
                                                         out, u8=True)
    else:
        _, scales, pad_xs, pad_ys = numpy_preproc_u8(images, S, letterbox,
                                                     out)
    return ([ex.boxes for ex in examples], [ex.labels for ex in examples],
            [im.shape[1] for im in images], [im.shape[0] for im in images],
            scales, pad_xs, pad_ys)


def build_packed_cache(parser, img_size: int, cache_dir: str,
                       letterbox: bool = False, log_every: int = 0) -> str:
    """One pass through ``parser`` -> packed cache directory (idempotent).

    The targets follow the Loader's (``pipeline.box_targets``), the images
    JAX's uint8 resize, so the cache equals the JAX package's."""
    n, S = len(parser), img_size
    if cache_valid(cache_dir, n, S, letterbox):
        return cache_dir
    os.makedirs(cache_dir, exist_ok=True)

    tmp = os.path.join(cache_dir, "images.u8.tmp")
    mm = np.memmap(tmp, np.uint8, "w+", shape=(n, S, S, 3))
    boxes_l, labels_l, offsets = [], [], [0]
    for start in range(0, n, BUILD_CHUNK):
        idx = range(start, min(start + BUILD_CHUNK, n))
        chunk = _resize_chunk(parser, idx, S, letterbox,
                              mm[idx.start:idx.stop])
        for bx, lb, w, h, s, px, py in zip(*chunk):
            boxes_l.append(box_targets(bx, w, h, s, px, py, S,
                                       letterbox).reshape(-1, 4))
            labels_l.append(np.asarray(lb, np.int32).reshape(-1))
            offsets.append(offsets[-1] + len(labels_l[-1]))
        if log_every and idx.stop // log_every > start // log_every:
            print(f"[cache] {idx.stop}/{n}", flush=True)
    mm.flush()
    del mm
    os.replace(tmp, os.path.join(cache_dir, "images.u8"))

    np.savez(os.path.join(cache_dir, "targets.npz"),
             boxes=(np.concatenate(boxes_l) if offsets[-1]
                    else np.zeros((0, 4), np.float32)).astype(np.float32),
             labels=(np.concatenate(labels_l) if offsets[-1]
                     else np.zeros((0,), np.int32)),
             offsets=np.asarray(offsets, np.int64))
    with open(os.path.join(cache_dir, "meta.json"), "w") as f:
        json.dump({"version": _VERSION, "n": n, "img_size": S,
                   "letterbox": bool(letterbox), "exif": True}, f)
    return cache_dir


class PackedCache:
    """Reader over a packed cache directory (memmap-backed, zero decode)."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            self.meta = json.load(f)
        n, S = self.meta["n"], self.meta["img_size"]
        self.images = np.memmap(os.path.join(cache_dir, "images.u8"),
                                np.uint8, "r", shape=(n, S, S, 3))
        t = np.load(os.path.join(cache_dir, "targets.npz"))
        self.boxes, self.labels = t["boxes"], t["labels"]
        self.offsets = t["offsets"]

    def __len__(self):
        return self.meta["n"]

    def willneed(self, idx) -> None:
        """Kernel read-ahead (madvise WILLNEED) for the rows in ``idx``:
        the Loader advises the next batches' rows while the card works on
        the current one, so the gather in :meth:`batch` finds their pages
        read instead of faulting each in on demand.  No-op where madvise
        is unavailable."""
        base = self.images.base
        if not (isinstance(base, mmap.mmap) and hasattr(base, "madvise")
                and hasattr(mmap, "MADV_WILLNEED")):
            return
        S = self.meta["img_size"]
        row = S * S * 3
        page = mmap.PAGESIZE
        total = len(base)
        for i in np.asarray(idx).ravel():
            off = (int(i) * row // page) * page          # page-align down
            ln = min(row + page, total - off)
            if ln > 0:
                try:
                    base.madvise(mmap.MADV_WILLNEED, off, ln)
                except (OSError, ValueError):  # pragma: no cover
                    return

    def batch(self, idx: np.ndarray, max_boxes: int,
              out: Optional[np.ndarray] = None) -> Batch:
        """Gather a padded uint8 batch for the given index array, its
        images into ``out`` [len(idx), S, S, 3] uint8 when given."""
        S = self.meta["img_size"]
        imgs = native.batch_out(out, len(idx), S, True)
        for k, i in enumerate(idx):                  # one row copy each
            imgs[k] = self.images[i]
        boxes_l = [self.boxes[self.offsets[i]:self.offsets[i + 1]]
                   for i in idx]
        labels_l = [self.labels[self.offsets[i]:self.offsets[i + 1]]
                    for i in idx]
        boxes, labels, mask = pad_targets(boxes_l, labels_l, max_boxes)
        return Batch(imgs, labels, boxes, mask)


def maybe_open(cache_dir: Optional[str], n: int, img_size: int,
               letterbox: bool) -> Optional[PackedCache]:
    """Open ``cache_dir`` if it holds a valid matching cache, else None:
    JAX's too, which lacks the ``exif`` mark."""
    if not cache_dir or not cache_valid(cache_dir, n, img_size, letterbox,
                                        exif=False):
        return None
    return PackedCache(cache_dir)
