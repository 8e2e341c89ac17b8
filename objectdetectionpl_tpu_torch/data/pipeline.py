"""Host-side batching pipeline: parsed examples -> fixed-shape Batch.

The port of ``objectdetectionpl_tpu/data/pipeline.py``.  The host decodes
and resizes to the static img_size; all augmentation runs on the device
(``augment.py``).  A batch comes one of three ways, which
``Loader.decode_path`` names:

- "cache": with ``cache_dir``, a gather of uint8 rows from the packed
  cache (``data/cache.py``), with read-ahead of the next batches' pages;
  the Trainer divides by 255 on the device.
- "fused": a parser with ``record(i) -> (path, boxes, labels)`` (the real
  datasets), whose route the Loader picks for each batch as the JAX
  package's does.  A batch whose records all end in ``.jpg`` / ``.jpeg``
  (any case) first goes through one ``native.decode_preproc_codes`` call,
  each worker thread decoding a file and resizing it straight into its
  slot of the float32 batch, as libjpeg's RGB decompression does there: a
  file at least twice img_size on both sides at libjpeg's DCT scale 1/2,
  1/4 or 1/8, its boxes normalized against its own (original) size; a cut
  or damaged file decodes as libjpeg decodes it.  If any file of the batch
  is one that call refuses (CMYK or YCCK, not a JPEG inside, ...), or a
  record has another name, the whole batch takes the parser route instead:
  every image read by the parser as ``cv2.imread`` reads it (full scale,
  EXIF-turned, any format ``native.decode_image`` reads), then resized.
  ``Loader.fused_batches`` and ``Loader.parser_batches`` count the two; a
  file that neither route reads raises ``native.ImageError`` (an OSError)
  naming the path.
- "parser": other parsers give their images themselves (Synthetic), which
  one ``native.preproc_batch`` call resizes.

The float32 resize is the port's host library (``data/native.py``), so
batches equal the JAX package's bit for bit; where the library cannot be
built, :func:`torch_resize`, the same resize by ``F.interpolate`` on the
host (within float32 rounding of it).  ``Loader.resize_path`` says which.
The uint8 resize that fills the cache is cv2's INTER_LINEAR, in the
library and, as its plain version, :func:`resize_u8` in numpy.

``Loader.batches(take)`` writes each batch's images into ``take(shape,
dtype)``: the Trainer passes its pinned upload buffers, so no batch is
allocated or copied on the host.

drop_last=True like the reference dataloaders.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.types import (Batch, pad_targets,
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


def _torch_preproc(images: Sequence[np.ndarray], S: int, letterbox: bool,
                   out: Optional[np.ndarray] = None):
    """``native.preproc_batch`` on torch: (batch, scales, pad_xs, pad_ys)."""
    out = native.batch_out(out, len(images), S, False)
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


COEF_SCALE = np.float32(2048)            # cv2's INTER_RESIZE_COEF_SCALE


def _linear_taps(n_src: int, n_dst: int, clamp_weights: bool):
    """One axis of cv2's INTER_LINEAR map on uint8: (i0, i1, a0, a1), the
    two source indices of each output index and their 11-bit weights.
    The weights are clamped at the edges of x only (``clamp_weights``);
    in y only the indices are."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp_weights:
        edge = (s < 0) | (s >= n_src - 1)
        f[edge] = 0.0
        s = np.where(s < 0, 0, np.where(s >= n_src - 1, n_src - 1, s))
    a0 = np.rint((np.float32(1) - f) * COEF_SCALE).astype(np.int64)
    a1 = np.rint(f * COEF_SCALE).astype(np.int64)
    return (np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), a0, a1)


def resize_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [h, w, 3]: ``cv2.resize(img, (w, h),
    interpolation=cv2.INTER_LINEAR)`` bit for bit, in numpy: the plain
    version of ``csrc/preproc.cc::linear_rect_u8``."""
    H, W = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(W, w, True)
    y0, y1, b0, b1 = _linear_taps(H, h, False)
    src = img.astype(np.int64)
    rows = (src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None]) >> 4
    out = (((b0[:, None, None] * rows[y0]) >> 16)
           + ((b1[:, None, None] * rows[y1]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def letterbox_u8(img: np.ndarray, S: int):
    """The JAX package's ``_resize_letterbox`` with :func:`resize_u8`:
    (canvas uint8 [S, S, 3], scale, pad_x, pad_y), the scale in float64
    and the sizes rounded half to even, on gray 114."""
    h, w = img.shape[:2]
    scale = S / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    canvas = np.full((S, S, 3), 114, np.uint8)
    py, px = (S - nh) // 2, (S - nw) // 2
    canvas[py:py + nh, px:px + nw] = resize_u8(img, nw, nh)
    return canvas, scale, px, py


def numpy_preproc_u8(images: Sequence[np.ndarray], S: int, letterbox: bool,
                     out: Optional[np.ndarray] = None):
    """``native.preproc_batch(..., u8=True)`` in numpy: (batch uint8,
    scales, pad_xs, pad_ys)."""
    out = native.batch_out(out, len(images), S, True)
    scales = np.ones(len(images), np.float32)
    pads = np.zeros((2, len(images)), np.float32)
    for i, img in enumerate(images):
        if letterbox:
            out[i], scales[i], pads[0, i], pads[1, i] = letterbox_u8(img, S)
        else:
            out[i] = resize_u8(img, S, S)
    return out, scales, pads[0], pads[1]


class Loader:
    """Iterates padded batches over a parser (or an index subset of one)."""

    def __init__(self, parser, img_size: int, batch_size: int,
                 max_boxes: int = 100, shuffle: bool = False, seed: int = 0,
                 indices: Optional[Sequence[int]] = None,
                 drop_last: bool = True, limit_batches: Optional[int] = None,
                 letterbox: bool = False, num_shards: int = 1,
                 shard_id: int = 0, cache_dir: Optional[str] = None,
                 read_ahead_batches: int = 32):
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
        # The packed cache (data/cache.py): epochs gather uint8 rows and
        # read the next ``read_ahead_batches`` batches' pages ahead.  A
        # cache_dir without a cache of this geometry is refused (the JAX
        # Loader decodes instead).
        self.cache = None
        self.read_ahead_batches = max(int(read_ahead_batches), 0)
        if cache_dir:
            from objectdetectionpl_tpu_torch.data import cache as cache_lib
            self.cache = cache_lib.maybe_open(cache_dir, len(parser),
                                              img_size, letterbox)
            if self.cache is None:
                raise ValueError(
                    f"{cache_dir} holds no packed cache of {len(parser)} "
                    f"images at {img_size} px, letterbox {letterbox}: "
                    f"build it with cache.build_packed_cache")
        self.resize_path = "native" if native.available() else "torch"
        self.decode_path = ("cache" if self.cache is not None else
                            "fused" if hasattr(parser, "record") else
                            "parser")
        # batches that took each route (decode_path "fused")
        self.fused_batches = self.parser_batches = 0

    def _fused(self, idx, out: np.ndarray):
        """The batch of records ``idx`` through the fused call into ``out``,
        or None when the batch must take the parser route: a record not
        named .jpg / .jpeg, or a file the call refuses."""
        recs = [self.parser.record(int(i)) for i in idx]
        if not all(r[0].lower().endswith((".jpg", ".jpeg")) for r in recs):
            return None
        *batch, codes = native.decode_preproc_codes(
            [r[0] for r in recs], self.img_size, self.letterbox, out,
            max_denom=native.MAX_DENOM)
        if codes.any():
            return None
        self.fused_batches += 1
        return (*batch, [r[1] for r in recs], [r[2] for r in recs])

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
        return self.batches()

    def batches(self, take: Optional[Callable] = None) -> Iterator[Batch]:
        """The next epoch's batches, each batch's images written into
        ``take(shape, dtype)`` (default: a new array each batch)."""
        take = take or np.empty
        order = self.indices.copy()
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        self.epoch += 1
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards][:self._shard_len()]

        S, bs = self.img_size, self.batch_size
        if self.cache is not None:
            ra = self.read_ahead_batches
            if ra:
                self.cache.willneed(order[:ra * bs])
            for b in range(len(self)):
                idx = order[b * bs:(b + 1) * bs]
                if ra:
                    self.cache.willneed(order[(b + ra) * bs:
                                              (b + ra + 1) * bs])
                yield self.cache.batch(idx, self.max_boxes,
                                       take((len(idx), S, S, 3), np.uint8))
            return

        preproc = (native.preproc_batch if self.resize_path == "native"
                   else _torch_preproc)
        for b in range(len(self)):
            idx = order[b * bs:(b + 1) * bs]
            out = take((len(idx), S, S, 3), np.float32)
            fused = None
            if self.decode_path == "fused":
                fused = self._fused(idx, out)
            if fused is not None:
                imgs, ws, hs, scales, pad_xs, pad_ys, boxes_px, labels_l = \
                    fused
            else:
                examples = [self.parser[int(i)] for i in idx]
                imgs, scales, pad_xs, pad_ys = preproc(
                    [ex.image for ex in examples], S, self.letterbox, out)
                hs = [ex.image.shape[0] for ex in examples]
                ws = [ex.image.shape[1] for ex in examples]
                boxes_px = [ex.boxes for ex in examples]
                labels_l = [ex.labels for ex in examples]
                self.parser_batches += self.decode_path == "fused"
            boxes_l = [box_targets(bx, w, h, s, px, py, S, self.letterbox)
                       for bx, w, h, s, px, py in zip(boxes_px, ws, hs,
                                                      scales, pad_xs, pad_ys)]
            boxes, labels, mask = pad_targets(boxes_l, labels_l,
                                              self.max_boxes)
            yield Batch(imgs, labels, boxes, mask)


def box_targets(boxes_px: np.ndarray, w: int, h: int, s: float, px: float,
                py: float, S: int, letterbox: bool) -> np.ndarray:
    """Top-left pixel xywh of a w x h image -> normalized center xywh of
    its resized (or letterboxed: scale ``s``, pads ``px``, ``py``) image."""
    if letterbox:
        return _letterbox_boxes(boxes_px, float(s), float(px), float(py), S)
    return topleft_to_center_norm(boxes_px, int(w), int(h))


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
