"""Host-side batching pipeline: parsed examples -> fixed-shape Batch.

The port of ``objectdetectionpl_tpu/data/pipeline.py``.  The host decodes
and resizes to the static img_size; normalization happens here (float32 in
[0, 1]) and all augmentation runs on the device (``augment.py``).

Decode: the images of a parser with ``record(i) -> (path, boxes,
labels)`` (VOC, COCO) are decoded by the port's JPEG decoder with one
``native.decode_batch`` call per batch, on a pool of threads; a file it
cannot read raises, naming the path.  Other parsers give their images
themselves (Synthetic).
``Loader.decode_path`` says which ("native" or "parser").

Resize: the native library ``native/preproc.cc`` through the port's own
binding (``data/native.py``), so batches equal the JAX package's bit for
bit; where the library cannot be built, :func:`torch_resize`, the same
resize by ``F.interpolate`` on the host (within float32 rounding of it).
``Loader.resize_path`` says which one a loader uses.  The packed cache
(``data/cache.py``) is not ported yet (ROADMAP A8 step 6b).

drop_last=True like the reference dataloaders.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.types import (Batch, Example,
                                                    pad_targets,
                                                    topleft_to_center_norm)

INV_255 = np.float32(1.0) / np.float32(255.0)
GRAY = np.float32(114.0) / np.float32(255.0)     # letterbox padding


def torch_resize(img: np.ndarray, w: int, h: int) -> torch.Tensor:
    """uint8 [H, W, 3] -> float32 [h, w, 3] in [0, 1]: the bilinear resize
    of ``native/preproc.cc::bilinear_rect`` (half-pixel centers, taps
    clamped to the image, then scaled by 1/255) with ``F.interpolate`` on
    the host."""
    src = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)
    out = F.interpolate(src[None].to(torch.float32), size=(h, w),
                        mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0) * float(INV_255)


def _torch_preproc(images: Sequence[np.ndarray], S: int, letterbox: bool):
    """``native.preproc_batch`` on torch: (batch, scales, pad_xs, pad_ys)."""
    out = np.empty((len(images), S, S, 3), np.float32)
    dst = torch.from_numpy(out)
    scales = np.ones(len(images), np.float32)
    pads = np.zeros((2, len(images)), np.float32)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        if not letterbox:
            dst[i].copy_(torch_resize(img, S, S))
            continue
        scale = np.float32(S) / np.float32(max(h, w))
        nh = int(np.float32(h) * scale + np.float32(0.5))
        nw = int(np.float32(w) * scale + np.float32(0.5))
        py, px = (S - nh) // 2, (S - nw) // 2
        dst[i].fill_(float(GRAY))
        dst[i, py:py + nh, px:px + nw].copy_(torch_resize(img, nw, nh))
        scales[i], pads[0, i], pads[1, i] = scale, px, py
    return out, scales, pads[0], pads[1]


class Loader:
    """Iterates padded batches over a parser (or an index subset of one)."""

    def __init__(self, parser, img_size: int, batch_size: int,
                 max_boxes: int = 100, shuffle: bool = False, seed: int = 0,
                 indices: Optional[Sequence[int]] = None,
                 drop_last: bool = True, limit_batches: Optional[int] = None,
                 letterbox: bool = False, num_shards: int = 1,
                 shard_id: int = 0, cache_dir: Optional[str] = None):
        if cache_dir:
            raise NotImplementedError("the packed cache (data/cache.py) is "
                                      "not ported yet (ROADMAP A8 step 6b)")
        self.parser = parser
        self.img_size = img_size
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.indices = (np.asarray(indices, np.int64) if indices is not None
                        else np.arange(len(parser)))
        self.drop_last = drop_last
        self.limit_batches = limit_batches
        self.letterbox = letterbox
        # Per-process input sharding: every process shuffles the FULL index
        # list with the same seed, then takes a process-strided,
        # equal-length slice (the DistributedSampler analogue).
        self.num_shards = max(int(num_shards), 1)
        self.shard_id = int(shard_id)
        self.resize_path = "native" if native.available() else "torch"
        self.decode_path = "native" if hasattr(parser, "record") else "parser"

    def _shard_len(self) -> int:
        return len(self.indices) // self.num_shards

    def __len__(self):
        n_items = (self._shard_len() if self.num_shards > 1
                   else len(self.indices))
        n = n_items // self.batch_size
        if not self.drop_last and n_items % self.batch_size:
            n += 1
        return min(n, self.limit_batches) if self.limit_batches else n

    def __iter__(self) -> Iterator[Batch]:
        order = self.indices.copy()
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        self.epoch += 1
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards][:self._shard_len()]

        S = self.img_size
        preproc = (native.preproc_batch if self.resize_path == "native"
                   else _torch_preproc)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            examples = self._examples(idx)
            imgs, scales, pad_xs, pad_ys = preproc(
                [ex.image for ex in examples], S, self.letterbox)
            boxes_l = []
            for ex, s, px, py in zip(examples, scales, pad_xs, pad_ys):
                h, w = ex.image.shape[:2]
                if self.letterbox:
                    boxes_l.append(_letterbox_boxes(ex.boxes, s, px, py, S))
                else:
                    boxes_l.append(topleft_to_center_norm(ex.boxes, w, h))
            boxes, labels, mask = pad_targets(
                boxes_l, [ex.labels for ex in examples], self.max_boxes)
            yield Batch(imgs, labels, boxes, mask)

    def _examples(self, idx) -> List[Example]:
        if self.decode_path == "native":
            recs = [self.parser.record(int(i)) for i in idx]
            images = native.decode_batch([r[0] for r in recs])
            return [Example(im, bx, lb)
                    for im, (_, bx, lb) in zip(images, recs)]
        return [self.parser[int(i)] for i in idx]


def _letterbox_boxes(boxes_px: np.ndarray, s: float, px: float, py: float,
                     S: int) -> np.ndarray:
    """Top-left pixel xywh -> normalized center xywh under letterbox."""
    bx = boxes_px.astype(np.float32).reshape(-1, 4)
    return np.stack([
        ((bx[:, 0] + bx[:, 2] / 2) * s + px) / S,
        ((bx[:, 1] + bx[:, 3] / 2) * s + py) / S,
        bx[:, 2] * s / S, bx[:, 3] * s / S], -1)


def prefetch(gen, depth: int = 2):
    """Run a generator in a background thread with a bounded queue.

    Overlaps host work (decode, resize, the copy to the device and the
    augmentation's launches) with the device's work on earlier items.
    Items come out in order; an exception raised in the thread is raised
    again here after the items before it.  Closing this generator early
    stops the thread at its next item.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
    end = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for item in gen:
                if stop.is_set():
                    return
                q.put(item)
        except BaseException as e:      # propagate into the consumer
            err.append(e)
        finally:
            q.put(end)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while thread.is_alive():        # unblock a put on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()


def random_split_indices(n: int, frac: float = 0.8, seed: int = 42
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded 80/20 split of range(n)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    k = int(round(n * frac))
    return order[:k], order[k:]
