"""Trainer: config-driven fit / validate / test loop.

The port of ``objectdetectionpl_tpu/train/loop.py``, method for method:

- fit: epochs over the train loader, each batch moved to the device and
  augmented there (``mosaic_batch`` when ``cfg.mosaic > 0``, then
  ``augment_batch``, one warp-kernel launch per microbatch), in a
  background thread when ``prefetch_batches > 0``.  On
  CUDA the Loader writes each batch's images straight into a ring of
  pinned host buffers (:class:`PinnedRing`), from which it is copied
  asynchronously; uint8 batches (the packed cache) become float32 / 255
  on the device, as in JAX.  Gradient accumulation over ``[A, mB, ...]``
  stacks with a zero-weight flush of a partial window; per-step loss
  scalars, per-epoch means, throughput, parameter histograms and device
  memory; the learning rate stepped per epoch on val_loss; top-k
  checkpoints, early stopping and a warm start from the best checkpoint.
- test: ``predict_step`` (forward with the EMA weights when enabled +
  decode + the NMS kernel, once per batch) and, for YOLOv2/v3/v4, the
  per-grid statistics of a second eval forward -> one host fetch per
  batch -> greedy TP matching -> ``ap_per_class`` mAP; Test/* scalars
  (``Test/{g}/{key}`` per grid), GT | pred image panels and a stdout
  table.

The augmentation (mosaic included) draws from a ``torch.Generator`` on
the device seeded with ``seed + 1``; the JAX Trainer draws from
``jax.random``, so fits differ between the packages (ROADMAP §C) while
everything after the draw is the same.  The tuner (``train/tune.py``)
runs from ``cli.run``.  Not ported yet, and raising when asked for: torch
checkpoints (A11) and a model axis in ``mesh_shape`` (A12).

Under a process group (``parallel/distributed.py``, one rank a card)
every rank trains on its Loader shard of ``batch_size`` images a
microbatch, so the global batch is R x ``batch_size``; the train step is
the global batch's (global BN moments, loss normalisers and mosaic
partners, summed gradients).  The state is broadcast from rank 0 after
construction and after a restore; validation and test run the whole set
on every rank, and rank 0's val_loss drives the scheduler, the
checkpoints and early stopping on every rank.  Rank 0 alone writes (run
directory, metrics, checkpoints) and prints.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data import build_datamodule
from objectdetectionpl_tpu_torch.data.augment import (augment_batch,
                                                      mosaic_batch)
from objectdetectionpl_tpu_torch.data.pipeline import prefetch
from objectdetectionpl_tpu_torch.data.types import Batch
from objectdetectionpl_tpu_torch.device import DeviceLike, resolve_device
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.ops import boxes as box_ops
from objectdetectionpl_tpu_torch.ops import losses as loss_lib
from objectdetectionpl_tpu_torch.ops import metrics as metric_lib
from objectdetectionpl_tpu_torch.ops import yolo_stats
from objectdetectionpl_tpu_torch.parallel import distributed, make_mesh
from objectdetectionpl_tpu_torch.train import checkpoint as ckpt_lib
from objectdetectionpl_tpu_torch.train import optim
from objectdetectionpl_tpu_torch.train import state as state_lib
from objectdetectionpl_tpu_torch.train import step as step_lib
from objectdetectionpl_tpu_torch.utils import summary as summary_lib
from objectdetectionpl_tpu_torch.utils import viz
from objectdetectionpl_tpu_torch.utils.logging import (MetricWriter,
                                                       log_param_histograms)
from objectdetectionpl_tpu_torch.utils.profiler import (device_memory_stats,
                                                        start_trace,
                                                        stop_trace)


def _check_ported(cfg: Config) -> None:
    if cfg.torch_ckpt:
        raise NotImplementedError("torch_ckpt is not ported yet "
                                  "(ROADMAP A11)")


def _say(*args) -> None:
    """print, on rank 0 only."""
    if distributed.process_index() == 0:
        print(*args)


def _to_host(tensors):
    """Tensors -> numpy, one synchronisation for all of them (bf16 as
    f32, which holds every bf16 value)."""
    out = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    return [(t.float() if t.dtype == torch.bfloat16 else t).numpy()
            for t in out]


class PinnedRing:
    """Pinned host buffers for the uploads to the card, allocated once and
    reused round robin, one slot a batch.

    The Loader writes a batch's images into :meth:`take` (the next slot's
    buffer); :meth:`upload` copies the batch's other arrays into that
    slot's buffers, starts the asynchronous copies to the card and records
    a CUDA event after them.  ``take`` hands a slot out again only once its
    event has completed: a buffer is never rewritten while a copy may
    still read it.  With ``prefetch`` batches queued on the card side, the
    ring needs ``prefetch + 2`` slots so that the Loader seldom waits."""

    def __init__(self, slots: int, device: torch.device):
        self.device = device
        self.buffers: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(slots)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        self.next = 0

    def _view(self, k: int, name: str, shape, dtype) -> np.ndarray:
        """Slot ``k``'s buffer ``name`` as a numpy array; it grows to fit."""
        dtype = np.dtype(dtype)
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self.buffers[k].get(name)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self.buffers[k][name] = buf
        return buf[:nbytes].numpy().view(dtype).reshape(shape)

    def take(self, shape, dtype) -> np.ndarray:
        """The next slot's image buffer, once no copy reads it."""
        k = self.next
        self.next = (k + 1) % len(self.buffers)
        if self.events[k] is not None:
            self.events[k].synchronize()
            self.events[k] = None
        return self._view(k, "images", shape, dtype)

    def _slot_of(self, a: np.ndarray) -> Optional[int]:
        for k, bufs in enumerate(self.buffers):
            if "images" in bufs and bufs["images"].data_ptr() == \
                    a.ctypes.data:
                return k
        return None

    def upload(self, batch: Batch) -> List[torch.Tensor]:
        """The batch's arrays on the card, copied from the slot its images
        were written into by :meth:`take`."""
        k = self._slot_of(batch.images)
        if k is None:
            raise ValueError("PinnedRing.upload takes a batch whose images "
                             "were written into PinnedRing.take()")
        host = [batch.images]
        for name, a in zip(Batch._fields[1:], batch[1:]):
            host.append(self._view(k, name, a.shape, a.dtype))
            np.copyto(host[-1], a)
        out = [torch.from_numpy(a).to(self.device, non_blocking=True)
               for a in host]
        self.events[k] = torch.cuda.Event()
        self.events[k].record()
        return out


class Trainer:
    def __init__(self, cfg: Config, device: DeviceLike = None):
        self.cfg = cfg
        _check_ported(cfg)
        self.mesh = make_mesh(cfg.mesh_shape)
        self.device = resolve_device(device)
        self.dm = build_datamodule(cfg)
        self.classes = self.dm.get_class()
        self.num_classes = len(self.classes)
        self.img_size = cfg.effective_img_size
        # the Loaders write into these buffers on CUDA; numpy arrays of
        # their own on the CPU
        self.ring = (PinnedRing(max(cfg.prefetch_batches, 0) + 2, self.device)
                     if self.device.type == "cuda" else None)
        self.take = self.ring.take if self.ring is not None else None

        dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                 else torch.float32)
        self.model = build_model(cfg.model_name, self.num_classes,
                                 dtype=dtype, yolov5_type=cfg.type,
                                 remat=cfg.remat, ssd_bn=cfg.ssd_bn,
                                 device=self.device, seed=cfg.seed)
        self.loss_fn = loss_lib.make_loss(
            cfg.model_name, self.num_classes, self.img_size,
            coord_criterion=cfg.coord_criterion,
            cls_criterion=cfg.cls_criterion,
            v3_double_stride=cfg.v3_double_stride)
        self.optimizer = optim.build_optimizer(cfg, self.model.parameters())
        self.scheduler = optim.build_scheduler(cfg)
        self.state = state_lib.create_train_state(
            self.model, self.optimizer, ema_decay=cfg.ema_decay)
        distributed.broadcast_state(self.state)
        self.aug_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)

        self.train_step = step_lib.make_train_step(
            self.model, self.loss_fn, self.optimizer,
            cfg.accumulate_grad_batches, ema_decay=cfg.ema_decay)
        self.eval_step = step_lib.make_eval_step(self.model, self.loss_fn)
        self.postprocess = step_lib.make_postprocess(
            cfg.model_name, self.num_classes, self.img_size,
            conf_thres=cfg.conf_thres, nms_thres=cfg.nms_thres,
            top_k=cfg.nms_top_k)
        self.predict_step = step_lib.make_predict_step(
            self.model, self.postprocess)

        # log_dir/<dataset>/<model>
        self.run_dir = os.path.join(cfg.log_dir, cfg.data_module,
                                    cfg.model_name)
        self.writer = MetricWriter(self.run_dir)
        self.ckpt = ckpt_lib.CheckpointManager(
            os.path.join(self.run_dir, "checkpoints"), cfg.save_top_k)
        self.early_stop = ckpt_lib.EarlyStopping(cfg.early_stop_patience)
        self.global_step = 0
        if distributed.process_index() == 0:
            summary_lib.save_summary(self.model, self.run_dir)

    # ------------------------------------------------------------------ fit --

    def maybe_restore(self):
        """Warm-start from the best checkpoint if there is one; one that
        does not fit this state is skipped."""
        try:
            restored = self.ckpt.restore(self.state)
        except ValueError as e:
            _say(f"[trainer] checkpoint restore skipped: {e}")
            return
        if restored is not None:
            self.state = restored
            distributed.broadcast_state(self.state)
            _say(f"[trainer] restored best checkpoint "
                 f"(step {self.ckpt.best_step()})")

    def _device_batch(self, batch: Batch, augment: bool):
        if self.ring is not None:
            images, labels, boxes, mask = self.ring.upload(batch)
        else:
            images, labels, boxes, mask = (torch.from_numpy(a).to(self.device)
                                           for a in batch)
        if images.dtype == torch.uint8:
            # packed-cache batches come as uint8; normalized here
            images = images.to(torch.float32) / 255.0
        if augment:
            if self.cfg.mosaic > 0:
                images, boxes, labels, mask = mosaic_batch(
                    images, boxes, labels, mask, p=self.cfg.mosaic,
                    generator=self.aug_gen)
            images, boxes, mask = augment_batch(images, boxes, mask,
                                                generator=self.aug_gen)
        return images, labels, boxes, mask

    def fit(self):
        cfg = self.cfg
        A = cfg.accumulate_grad_batches
        self.maybe_restore()
        val_metric: Optional[float] = None

        for epoch in range(cfg.max_epochs):
            t_epoch = time.time()
            if epoch == 0:
                self.writer.text("model/graph",
                                 summary_lib.model_summary(self.model))
            lr = self.scheduler.step(val_metric)
            optim.set_learning_rate(self.optimizer, lr)
            self.writer.scalar("lr-Adam" if cfg.optimizer == "Adam"
                               else f"lr-{cfg.optimizer}", lr, epoch)

            epoch_metrics: List[Dict[str, float]] = []
            micro: List = []
            t0 = time.time()
            n_imgs = 0
            prof = (start_trace(os.path.join(self.run_dir, "profile"))
                    if cfg.profile_steps > 0 and epoch == 0 else None)
            first_batch = True
            # host preprocessing, the copy to the device and the
            # augmentation's launches run in a background thread,
            # overlapping the device's work on earlier steps
            batches = (self._device_batch(b, augment=True)
                       for b in self.dm.train_dataloader().batches(self.take))
            if cfg.prefetch_batches > 0:
                batches = prefetch(batches, cfg.prefetch_batches)
            with contextlib.closing(batches):   # ends the thread on error
                for device_batch in batches:
                    micro.append(device_batch)
                    if cfg.view_mark and first_batch:
                        self._view_mark(micro[0], epoch)
                        first_batch = False
                    if len(micro) < A:
                        continue
                    stacked = [torch.stack([m[i] for m in micro])
                               for i in range(4)]
                    micro = []
                    self.state, metrics = self.train_step(self.state, *stacked)
                    n_imgs += stacked[0].shape[0] * stacked[0].shape[1]
                    metrics, prof = self._log_train_step(metrics, cfg, prof)
                    epoch_metrics.append(metrics)
                    self.global_step += 1

            if micro:
                # flush the partial accumulation window with zero-weight
                # padding microbatches
                n_real = len(micro)
                n_imgs += sum(m[0].shape[0] for m in micro)
                while len(micro) < A:
                    micro.append(micro[-1])
                stacked = [torch.stack([m[i] for m in micro])
                           for i in range(4)]
                weights = [1.0] * n_real + [0.0] * (A - n_real)
                micro = []
                self.state, metrics = self.train_step(self.state, *stacked,
                                                      weights)
                metrics, prof = self._log_train_step(metrics, cfg, prof)
                epoch_metrics.append(metrics)
                self.global_step += 1
            if epoch_metrics:
                epoch_metrics = [{k: float(v) for k, v in m.items()}
                                 for m in epoch_metrics]
                means = {k: float(np.mean([m[k] for m in epoch_metrics]))
                         for k in epoch_metrics[0]}
                self.writer.scalars("Epoch", {f"{k}/Train": v
                                              for k, v in means.items()},
                                    epoch)
                dt = time.time() - t0
                self.writer.scalar("throughput/images_per_sec",
                                   n_imgs * self.mesh.data / max(dt, 1e-9),
                                   epoch)
            if cfg.histogram_every and epoch % cfg.histogram_every == 0:
                log_param_histograms(self.writer, self.model, epoch,
                                     max_tensors=50)
            for dev, stats in device_memory_stats().items():
                for k, v in stats.items():
                    self.writer.scalar(f"device/{dev}/{k}", v, epoch)
            if prof is not None:        # epoch shorter than profile_steps
                stop_trace(prof, os.path.join(self.run_dir, "profile"))

            # every rank ran the whole val set: rank 0's loss decides
            val_loss = distributed.broadcast_value(self.validate(epoch))
            val_metric = val_loss
            stop = False
            if val_loss is not None:
                self.ckpt.save(epoch, self.state, val_loss)
                stop = self.early_stop.update(val_loss)
            self.writer.scalar("time/epoch_seconds", time.time() - t_epoch,
                               epoch)
            self.writer.flush()
            if stop:
                _say(f"[trainer] early stopping at epoch {epoch}")
                break
        self.ckpt.wait()
        return self.state

    def _log_train_step(self, metrics, cfg, prof):
        """Per-step metric logging + profiler stop + NaN guard.  Steps that
        log pull their metrics to the host (a sync); the others keep them
        on the device until the epoch ends."""
        if prof is not None and self.global_step + 1 >= cfg.profile_steps:
            stop_trace(prof, os.path.join(self.run_dir, "profile"))
            prof = None
        if self.global_step % max(cfg.log_every_steps, 1) == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            if cfg.nan_check and not math.isfinite(metrics["loss"]):
                raise FloatingPointError(
                    f"non-finite loss at step {self.global_step}: "
                    f"{metrics} -- lower lr")
            for k, v in metrics.items():
                self.writer.scalar(f"Loss/{k}/Train", v, self.global_step)
        return metrics, prof

    def _view_mark(self, device_batch, epoch: int, max_images: int = 4):
        """Log augmented training images with GT boxes drawn."""
        images, labels, boxes, mask = device_batch
        n = min(images.shape[0], max_images)
        images, gt_xyxy, labels, mask = _to_host(
            (images[:n], box_ops.xywh_to_xyxy(boxes[:n]) * self.img_size,
             labels[:n], mask[:n]))
        for i in range(n):
            panel = viz.draw_boxes(images[i], gt_xyxy[i], labels[i],
                                   valid=mask[i])
            self.writer.image(f"view_mark/{i}", panel, epoch)

    def validate(self, epoch: int) -> Optional[float]:
        # per-batch metrics stay on the device; one pull at the end
        losses: List[Dict] = []
        for batch in self.dm.val_dataloader().batches(self.take):
            args = self._device_batch(batch, augment=False)
            losses.append(self.eval_step(self.state, *args))
        if not losses:
            return None
        keys = list(losses[0])
        flat = _to_host([m[k] for m in losses for k in keys])
        losses = [dict(zip(keys, flat[i:i + len(keys)]))
                  for i in range(0, len(flat), len(keys))]
        means = {k: float(np.mean([m[k] for m in losses])) for k in keys}
        self.writer.scalar("val_loss", means["loss"], epoch)
        self.writer.scalars("Epoch", {f"{k}/Val": v for k, v in means.items()},
                            epoch)
        return means["loss"]

    # ----------------------------------------------------------------- test --

    def _yolo_stat_fn(self):
        """The per-grid statistics of YOLOv2/v3/v4 under the weights
        ``predict_step`` serves (EMA when enabled), else None.  The anchors
        are divided by the stride once, whatever ``v3_double_stride``."""
        if self.cfg.model_name not in step_lib.YOLO_DECODE:
            return None
        per_scale = [torch.as_tensor(a, device=self.device)
                     for a in loss_lib.yolo_anchors_grid(self.cfg.model_name)]

        def stat_fn(images, labels, boxes, mask):
            with torch.inference_mode():
                out = torch.func.functional_call(
                    self.model, self.state.eval_params, (images,))
                return yolo_stats.yolo_statistics(out, labels, boxes, mask,
                                                  per_scale, self.num_classes)
        return stat_fn

    def test(self) -> Dict[str, float]:
        """mAP evaluation with NMS, one ``predict_step`` per test batch."""
        self.model.eval()
        stats = []
        target_classes: List[int] = []
        panels = 0
        yolo_stat_fn = self._yolo_stat_fn()
        grid_stats: List[Dict[str, float]] = []
        for batch in self.dm.test_dataloader().batches(self.take):
            images, labels, boxes, mask = self._device_batch(batch, False)
            res = self.predict_step(self.state, images)
            ys = ({} if yolo_stat_fn is None else
                  {f"{g}/{k}": v for g, d in
                   yolo_stat_fn(images, labels, boxes, mask).items()
                   for k, v in d.items()})
            # the reference ranks detections by column 4 of its NMS rows:
            # obj_conf for the YOLO families
            conf = (res.scores if self.cfg.model_name in ("SSD", "RetinaNet")
                    else res.obj)
            # one host fetch per batch for everything the numpy mAP path
            # and the panel need
            fetch = [res.boxes, conf, res.labels, res.valid,
                     box_ops.xywh_to_xyxy(boxes) * self.img_size, labels,
                     mask, *ys.values()] + ([images[0]] if panels < 4 else [])
            pboxes, conf, plabels, pvalid, gt_xyxy, labels, mask, *rest = \
                _to_host(fetch)
            if ys:
                grid_stats.append(dict(zip(ys, rest)))
            image0 = rest[len(ys):]
            s = metric_lib.batch_statistics(pboxes, conf, plabels, pvalid,
                                            gt_xyxy, labels, mask)
            stats.append(s)
            target_classes.extend(labels[mask].tolist())

            if image0:              # first image of the first batches
                gt_img = viz.draw_boxes(image0[0], gt_xyxy[0], labels[0],
                                        valid=mask[0])
                pr_img = viz.draw_boxes(image0[0], pboxes[0], plabels[0],
                                        valid=pvalid[0])
                self.writer.image(f"result/{panels}",
                                  viz.side_by_side(gt_img, pr_img), panels)
                panels += 1

        results = metric_lib.evaluate_map(stats, np.asarray(target_classes))
        for k in ("precision", "recall", "mAP", "f1"):
            self.writer.scalar(f"Test/{k}", results[k], 0)
        # per-grid YOLO statistics: means over the test batches
        for k in (grid_stats[0] if grid_stats else ()):
            results[k] = float(np.mean([s[k] for s in grid_stats]))
            self.writer.scalar(f"Test/{k}", results[k], 0)

        _say("---- mAP per class ----")
        for cid, ap in sorted(results["per_class_AP"].items()):
            name = (self.classes[cid] if 0 <= cid < len(self.classes)
                    else str(cid))
            _say(f"  {name}: {ap:.4f}")
        _say(f"mAP: {results['mAP']:.4f}")
        if grid_stats:
            _say("---- YOLO statistics per grid ----")
            for k in grid_stats[0]:
                _say(f"  {k}: {results[k]:.4f}")
        self.writer.flush()
        return results
