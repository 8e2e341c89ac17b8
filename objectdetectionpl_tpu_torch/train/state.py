"""Train state: the model (parameters + BatchNorm statistics), the optimizer,
the step count and an optional EMA copy of the parameters.

The port of ``objectdetectionpl_tpu/train/state.py``.  The JAX package keeps
all of this in one immutable pytree; here the model and the optimizer own
their tensors and a train step updates them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer]   # None for serving
    step: torch.Tensor                      # int64 scalar on the model's device
    ema_params: Optional[Dict[str, torch.Tensor]] = None   # None = disabled

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def model_axis(self):
        """How the model is split over a model axis
        (``parallel/mesh.py::shard_model_parallel``), or None."""
        return getattr(self.model, "model_axis", None)

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        """Parameters to evaluate/serve with (EMA when enabled)."""
        return self.ema_params if self.ema_params is not None else self.params


def create_train_state(model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       ema_decay: float = 0.0) -> TrainState:
    """Wrap an initialized model and its optimizer (None where nothing
    trains, as in serving); the EMA starts as a copy of the parameters when
    ``ema_decay > 0``."""
    device = next(model.parameters()).device
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if ema_decay > 0 else None)
    return TrainState(model=model, optimizer=optimizer,
                      step=torch.zeros((), dtype=torch.int64, device=device),
                      ema_params=ema)


def param_count(model: torch.nn.Module) -> int:
    """The number of parameters (BatchNorm statistics excluded, as they are
    not parameters in the JAX package either)."""
    return sum(p.numel() for p in model.parameters())
