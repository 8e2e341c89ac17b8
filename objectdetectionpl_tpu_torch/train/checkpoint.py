"""Checkpoints with top-k retention on val_loss + best-path persistence.

The port of ``objectdetectionpl_tpu/train/checkpoint.py``, synchronous, on
``torch.save`` / ``torch.load(weights_only=True)``.  A checkpoint is the
directory ``<directory>/<step>/`` (the Trainer's step is the epoch) with
``state.pt`` -- the model's ``state_dict`` (parameters and BN statistics),
the optimizer's ``state_dict``, the EMA copy or None, and the step count --
and ``metrics.json`` with its ``val_loss``.  It is written under a
temporary name and renamed into place, so a directory with a step's name
is complete.

Retention follows orbax's ``max_to_keep`` with ``best_fn`` in ``min``
mode, as the JAX manager configures it: after each save the ``save_top_k``
checkpoints of lowest val_loss stay (of equal ones, the later steps) and
the others are deleted; the best step is the one of lowest val_loss (of
equal ones, the latest); a step at or below the latest saved one is not
saved again.  ``best_model_path.txt`` holds the best checkpoint's path.

Under a process group rank 0 alone writes and deletes; every rank keeps
the same book of steps and val_losses (the Trainer hands every rank rank
0's val_loss), and a restore waits at a barrier before every rank reads
the same file (one file system for all ranks).  A state split over a model
axis (``parallel/mesh.py::shard_model_parallel``) is saved whole, gathered
by every rank, and a restore cuts each rank's slices from the whole.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch

from objectdetectionpl_tpu_torch.parallel import distributed

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


class CheckpointManager:
    def __init__(self, directory: str, save_top_k: Optional[int] = 3):
        self.directory = os.path.abspath(directory)
        self.writes = distributed.process_index() == 0
        if self.writes:
            os.makedirs(self.directory, exist_ok=True)
        self.save_top_k = save_top_k
        self._val_loss: Dict[int, float] = {}
        names = (os.listdir(self.directory)
                 if os.path.isdir(self.directory) else [])
        for name in names:
            metrics = os.path.join(self.directory, name, METRICS_FILE)
            if name.isdigit() and os.path.exists(metrics):
                with open(metrics) as f:
                    self._val_loss[int(name)] = json.load(f)["val_loss"]

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _by_quality(self) -> list:
        """Steps from worst to best (stable: ties keep step order)."""
        return sorted(sorted(self._val_loss), key=self._val_loss.__getitem__,
                      reverse=True)

    def steps(self) -> list:
        """The saved steps, in order."""
        return sorted(self._val_loss)

    def latest_step(self) -> Optional[int]:
        return max(self._val_loss) if self._val_loss else None

    def best_step(self) -> Optional[int]:
        order = self._by_quality()
        return order[-1] if order else None

    def save(self, step: int, state, val_loss: float) -> bool:
        """Save ``state`` (a ``TrainState``) as ``step``; returns False
        when the step is not after the latest saved one."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        self._val_loss[step] = float(val_loss)
        drop = []
        if self.save_top_k is not None:
            order = self._by_quality()
            drop = order[:max(len(order) - self.save_top_k, 0)]
            for old in drop:
                del self._val_loss[old]
        # a state split over a model axis is gathered whole by every rank
        whole = (state.model_axis.whole(state)
                 if state.model_axis is not None else None)
        if not self.writes:
            return True
        tmp = self._path(step) + f".tmp-{os.getpid()}"
        os.makedirs(tmp)
        opt = state.optimizer
        torch.save(whole or {
            "model": state.model.state_dict(),
            "optimizer": None if opt is None else opt.state_dict(),
            "ema": state.ema_params, "step": int(state.step)},
            os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), "w") as f:
            json.dump({"val_loss": float(val_loss)}, f)
        os.rename(tmp, self._path(step))
        for old in drop:
            shutil.rmtree(self._path(old))
        self.write_best_model_path()
        return True

    def load(self, step: int, device) -> dict:
        """The raw checkpoint of ``step``, its tensors on ``device``."""
        return torch.load(os.path.join(self._path(step), STATE_FILE),
                          map_location=device, weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (default: the best) into ``state`` in
        place, on the device of its model; returns the state, or None when
        there is no checkpoint.  Raises when the checkpoint does not fit
        the state (another model, an EMA where the state has none, or
        other optimizer parameter groups), before it changes the state."""
        step = self.best_step() if step is None else step
        if step is None:
            return None
        distributed.barrier()           # rank 0's saves are on disk
        ckpt = self.load(step, next(state.model.parameters()).device)
        if state.model_axis is not None:        # whole on disk: own slices
            ckpt = state.model_axis.own(state, ckpt)
        have = {k: v.shape for k, v in state.model.state_dict().items()}
        if {k: v.shape for k, v in ckpt["model"].items()} != have:
            raise ValueError(f"checkpoint {step} holds another model")
        if (ckpt["ema"] is None) != (state.ema_params is None):
            raise ValueError("the checkpoint and the state disagree on "
                             "whether an EMA is kept")
        if (state.ema_params is not None
                and ckpt["ema"].keys() != state.ema_params.keys()):
            raise ValueError("the checkpoint's EMA holds other parameters "
                             "than the state's")
        opt = ckpt["optimizer"]
        load_opt = state.optimizer is not None and opt is not None
        if load_opt and ([len(g["params"]) for g in opt["param_groups"]]
                         != [len(g["params"])
                             for g in state.optimizer.param_groups]):
            raise ValueError("the checkpoint's optimizer holds other "
                             "parameter groups than the state's")
        state.model.load_state_dict(ckpt["model"], strict=True)
        if load_opt:
            # the optimizer keeps its step counts on the host unless it is
            # capturable; load_state_dict would leave them on the card
            for s in opt["state"].values():
                if "step" in s:
                    s["step"] = s["step"].cpu()
            state.optimizer.load_state_dict(opt)
        if state.ema_params is not None:
            with torch.no_grad():
                for k, v in ckpt["ema"].items():
                    state.ema_params[k].copy_(v)
        state.step.fill_(ckpt["step"])
        return state

    # --- best-path txt parity --------------------------------------------

    @property
    def _best_path_file(self) -> str:
        return os.path.join(self.directory, "best_model_path.txt")

    def write_best_model_path(self):
        step = self.best_step()
        if step is not None:
            with open(self._best_path_file, "w") as f:
                f.write(self._path(step))

    def read_best_model_path(self) -> Optional[str]:
        if os.path.exists(self._best_path_file):
            with open(self._best_path_file) as f:
                return f.read().strip()
        return None

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        """Nothing to release."""


class EarlyStopping:
    """val_loss early stop, patience 3 by default."""

    def __init__(self, patience: int = 3, mode: str = "min"):
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def update(self, metric: float) -> bool:
        """Returns True when training should stop."""
        improved = (self.best is None
                    or (metric < self.best if self.mode == "min"
                        else metric > self.best))
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience
