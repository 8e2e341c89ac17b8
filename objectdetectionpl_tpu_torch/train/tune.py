"""The tuner: an LR range test and batch-size power scaling.

The port of ``objectdetectionpl_tpu/train/tune.py`` (the config's ``tune``,
``auto_lr_find`` and ``auto_scale_batch_size: power``; Lightning's
``trainer.tune``).  Both work on throwaway copies of the Trainer's model
and optimizer, so the live model, its BN statistics and the optimizer's
state are left as they were.

How a batch size is probed differs from JAX: the JAX package compiles the
train step ahead of time and reads the compiler's memory analysis, never
executing it.  PyTorch has no such analysis, so the port runs one train
step per candidate, as Lightning's 'power' mode does on a GPU, and
compares its peak memory with ``headroom`` x the device's memory
(ROADMAP §C).  On CUDA the peak is ``torch.cuda.max_memory_allocated``
over the step, everything the process holds on the card included.  On
the CPU, which has no such counter, it is the bytes of the tensors that
autograd keeps for the backward pass plus those of the parameters, their
gradients, the optimizer's state and the batch, each storage counted once.

Under a process group every rank runs the tuner through the distributed
train step (``train/step.py``), as every JAX process runs it: the losses
the sweep reads are the global ones, and the sweep's deadline is rank
0's, broadcast.  The memory probe steps each rank alone
(``distributed.local``: no collective, since a rank that runs out of
memory stops mid-step), and a batch fits when it fits on every rank.  So
every rank takes the same steps and gets the same suggestions.
"""

from __future__ import annotations

import copy
import gc
import math
import time
from typing import List, Optional

import numpy as np
import torch

from objectdetectionpl_tpu_torch.parallel import distributed
from objectdetectionpl_tpu_torch.train import optim
from objectdetectionpl_tpu_torch.train import state as state_lib
from objectdetectionpl_tpu_torch.train import step as step_lib

# what an allocation failure says where it is not a torch.cuda.OutOfMemoryError
_RESOURCE_MESSAGES = ("out of memory", "can't allocate memory",
                      "not enough memory", "alloc_failed")


def _throwaway(trainer, accum_steps: int):
    """Copies of the Trainer's model and optimizer (its state included) in
    a train state, and a train step made for them."""
    cfg = trainer.cfg
    model = copy.deepcopy(trainer.model)
    opt = optim.build_optimizer(cfg, model.parameters())
    opt.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))
    state = state_lib.create_train_state(model, opt, ema_decay=cfg.ema_decay)
    step = step_lib.make_train_step(model, trainer.loss_fn, opt, accum_steps,
                                    ema_decay=cfg.ema_decay)
    return state, step


def auto_lr_find(trainer, num_steps: int = 25, min_lr: float = 1e-7,
                 max_lr: float = 1.0, deadline_s: float = 300.0) -> float:
    """Exponential LR sweep on throwaway copies; returns the suggested LR.

    Each step takes ``accumulate_grad_batches`` augmented microbatches from
    the train loader (``trainer._device_batch``, the warp kernel's path).
    The sweep stops issuing steps once ``deadline_s`` is spent or a loss
    is not finite.  Suggestion: one decade below the LR of the steepest
    descent of the loss smoothed over 3 steps, clipped to the sweep's
    range; the config's lr when fewer than 3 steps ran.
    """
    t0 = time.monotonic()
    cfg = trainer.cfg
    lrs = np.geomspace(min_lr, max_lr, num_steps)
    state, step = _throwaway(trainer, cfg.accumulate_grad_batches)
    loader = trainer.dm.train_dataloader()
    it = loader.batches(trainer.take)
    losses: List[float] = []
    for lr in lrs:
        if distributed.broadcast_value(time.monotonic() - t0) > deadline_s:
            break             # budget spent: suggest from what we have
        optim.set_learning_rate(state.optimizer, float(lr))
        micro = []
        while len(micro) < cfg.accumulate_grad_batches:
            try:
                batch = next(it)
            except StopIteration:
                it = loader.batches(trainer.take)
                batch = next(it)
            micro.append(trainer._device_batch(batch, augment=True))
        stacked = [torch.stack([m[i] for m in micro]) for i in range(4)]
        state, metrics = step(state, *stacked)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            break
        losses.append(loss)

    if len(losses) < 3:
        return cfg.lr
    smooth = np.convolve(losses, np.ones(3) / 3, mode="valid")
    best = int(np.argmin(np.diff(smooth)))          # steepest descent
    suggestion = float(lrs[min(best + 1, len(lrs) - 1)]) / 10.0
    return float(np.clip(suggestion, min_lr, max_lr))


def _device_bytes_limit(device) -> float:
    """The memory budget of ``device`` in bytes: the card's total memory
    on CUDA, else the host's ``MemAvailable`` (``/proc/meminfo``), else
    unbounded."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    return float("inf")


def _is_resource_error(e: BaseException) -> bool:
    if isinstance(e, (torch.cuda.OutOfMemoryError, MemoryError)):
        return True
    return (isinstance(e, RuntimeError)
            and any(m in str(e).lower() for m in _RESOURCE_MESSAGES))


def _probe_batch(trainer, bs: int):
    """A [1, bs, ...] batch of the Trainer's shapes, one box an image."""
    S, M, dev = trainer.img_size, trainer.cfg.max_boxes, trainer.device
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand((1, bs, S, S, 3), generator=gen, device=dev)
    labels = torch.zeros((1, bs, M), dtype=torch.int32, device=dev)
    boxes = torch.tensor([0.5, 0.5, 0.25, 0.25],
                         device=dev).expand(1, bs, M, 4).contiguous()
    mask = torch.zeros((1, bs, M), dtype=torch.bool, device=dev)
    mask[..., 0] = True
    return images, labels, boxes, mask


def _counted_bytes(tensors, counted: dict) -> None:
    for t in tensors:
        s = t.untyped_storage()
        counted[s.data_ptr()] = s.nbytes()


def _step_peak_bytes(trainer, state, step, batch) -> int:
    """The peak memory of one train step (the module docstring's count)."""
    dev = trainer.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step(state, *batch)
        torch.cuda.synchronize(dev)
        return int(torch.cuda.max_memory_allocated(dev))
    counted: dict = {}

    def pack(t):
        _counted_bytes([t], counted)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step(state, *batch)
    params = list(state.model.parameters())
    _counted_bytes(params, counted)
    _counted_bytes([p.grad for p in params if p.grad is not None], counted)
    _counted_bytes(state.model.buffers(), counted)
    _counted_bytes([v for st in state.optimizer.state.values()
                    for v in st.values() if isinstance(v, torch.Tensor)],
                   counted)
    _counted_bytes(batch, counted)
    return sum(counted.values())


def probe_batch_size(trainer, bs: int) -> Optional[int]:
    """Peak bytes of one train step at batch ``bs`` on throwaway copies, or
    None when the step ran out of memory.  Any other error propagates.
    The failed step's tensors are freed, and the card's cache emptied,
    before this returns."""
    state, step = _throwaway(trainer, accum_steps=1)
    peak = None
    try:
        with distributed.local():     # the rank's own peak, no collective
            peak = _step_peak_bytes(trainer, state, step,
                                    _probe_batch(trainer, bs))
    except Exception as e:
        if not _is_resource_error(e):
            raise
    # the caught error's traceback held the failed step's frames: with it
    # gone, collect them before the next candidate allocates
    del state, step
    gc.collect()
    if trainer.device.type == "cuda":
        torch.cuda.empty_cache()
    return peak


def batch_fits(trainer, bs: int, headroom: float = 0.9) -> bool:
    """True when a train step at batch ``bs`` runs and its peak memory is
    at most ``headroom`` x the device's memory, on every rank of a
    process group."""
    peak = probe_batch_size(trainer, bs)
    return distributed.all_true(
        peak is not None
        and peak <= headroom * _device_bytes_limit(trainer.device))


def auto_scale_batch_size(trainer, start: int = 2, max_trials: int = 6,
                          headroom: float = 0.9) -> int:
    """'power' scaling: double the batch from ``start`` until it no longer
    fits; returns the last that did (``start`` when none did)."""
    good = start
    bs = start
    for _ in range(max_trials):
        if not batch_fits(trainer, bs, headroom):
            break
        good = bs
        bs *= 2
    return good
