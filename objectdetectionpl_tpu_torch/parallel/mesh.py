"""The ('data', 'model') mesh: the port of ``objectdetectionpl_tpu/parallel/mesh.py``.

In the JAX package a mesh is an array of devices that sharding
annotations refer to, and XLA inserts the collectives.  Here a rank is a
device: :func:`make_mesh` lays the process group out as (data, model),
rank ``r`` at ``(r // model, r % model)`` as JAX's row-major
``reshape``, and makes the groups of each axis
(``distributed.set_mesh``).

The data axis is data parallelism (``parallel/distributed.py``).  The
model axis is tensor parallelism by JAX's rule
(:func:`model_parallel_shardings`): an array whose last *flax* dimension
divides by the axis and is at least ``max(model, min_dim)`` is split on
it.  That dimension is a conv's output channels, dim 0 of the port's OIHW
weight, and the dimension of its bias and of BN's vectors.
:func:`shard_model_parallel` keeps this rank's contiguous slice of each
split tensor (its EMA copy and optimizer state with it) and hooks the
layers that hold them:

- a split ``ConvBN`` computes its slice of the output channels, BN (its
  moments over the data group) and the activation run on them, and the
  block's output is gathered over the model group; a split ``Conv`` the
  same without BN; a split ``BatchNorm`` outside a ``ConvBN`` normalises
  its slice of the input's channels, then gathers;
- every tensor that leaves a split layer is whole again, so the layers
  that read it (replicated convs, adds, concats, reorgs, upsamples) run
  whole on every rank of the model group, identically;
- backward: the gather hands each rank its own slice of the incoming
  gradient (downstream every rank computed the same thing, so each holds
  the same full gradient: a sum would be ``model`` times too large), and
  the gradient of a split layer's input, of which each rank holds its
  channels' share, is summed over the model group.

Gradients of split and replicated parameters alike are then summed over
the data group only, and the losses divide by the data axis's size.
:func:`gather_state_dict` gathers a split model's state back into whole
tensors (the tests, and ``train/checkpoint.py`` for a split state).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from objectdetectionpl_tpu_torch.parallel import distributed
from objectdetectionpl_tpu_torch.parallel.distributed import process_count


class Mesh(NamedTuple):
    data: int
    model: int


def coords(mesh: Mesh, rank: int) -> Tuple[int, int]:
    """(data index, model index) of global rank ``rank``."""
    return divmod(rank, mesh.model)


def make_mesh(shape: Optional[Sequence[int]] = None) -> Mesh:
    """``shape`` (data, model), default all ranks on 'data'.  ``data *
    model`` must be the world size (ValueError otherwise; JAX takes the
    first devices of a larger set).  Lays the ranks out on it."""
    world = process_count()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"mesh shape {shape}: expected (data, model), "
                         f"each at least 1")
    data, model = shape
    if data * model != world:
        raise ValueError(f"mesh shape {shape} needs {data * model} ranks "
                         f"({data} on 'data' x {model} on 'model'), the "
                         f"process group has {world}")
    distributed.set_mesh(data, model)
    return Mesh(data, model)


def model_parallel_shardings(mesh: Mesh, tree, min_dim: int = 8
                             ) -> Dict[str, Optional[int]]:
    """JAX's tensor-parallel rule on the model's state_dict: ``{key: 0}``
    for a tensor split over 'model' on dim 0 (the flax layout's last
    dimension: output channels of an OIHW kernel, the length of a vector)
    when that dimension divides by the axis size and is at least
    ``max(model, min_dim)``, ``{key: None}`` for a replicated one.
    ``tree`` is a module or a state_dict.  With a model axis of 1 nothing
    splits."""
    m = mesh.model
    sd = tree.state_dict() if isinstance(tree, nn.Module) else tree
    return {k: 0 if m > 1 and v.dim() >= 1 and v.shape[0] % m == 0
            and v.shape[0] >= max(m, min_dim) else None
            for k, v in sd.items()}


# --- the model axis's collectives --------------------------------------------


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, contiguous, in ``t``'s dtype (half
    types reduced in float32, exact for a sum of one value and zeros)."""
    half = t.dtype in (torch.float16, torch.bfloat16)
    buf = t.to(torch.float32 if half else t.dtype).contiguous()
    dist.all_reduce(buf, group=group)
    return buf.to(t.dtype)


def _channels_last(x: torch.Tensor) -> bool:
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


class _ToModelGroup(torch.autograd.Function):
    """Forward the identity; backward the gradient summed over the model
    group (each rank's split layer gives its channels' share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _GatherChannels(torch.autograd.Function):
    """Forward each rank's channel slice (dim 1) gathered in model-index
    order, in the slice's memory format; backward this rank's slice of
    the gradient."""

    @staticmethod
    def forward(ctx, x, group, model, index):
        n = x.shape[1]
        ctx.rows = slice(index * n, (index + 1) * n)
        full = x.new_zeros((x.shape[0], n * model, *x.shape[2:]))
        full[:, ctx.rows] = x
        full = _summed(full, group)
        return (full.contiguous(memory_format=torch.channels_last)
                if _channels_last(x) else full)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rows], None, None, None


def _gather_dim0(t: torch.Tensor, axes) -> torch.Tensor:
    """A dim-0 slice of each rank of the model group, whole (no grad)."""
    n = t.shape[0]
    full = t.new_zeros((n * axes.model, *t.shape[1:]))
    full[axes.model_index * n:(axes.model_index + 1) * n] = t
    return _summed(full, axes.model_group)


def _slice_dim0(t: torch.Tensor, axes) -> torch.Tensor:
    n = t.shape[0] // axes.model
    return t[axes.model_index * n:(axes.model_index + 1) * n].clone()


class ModelAxis:
    """What :func:`shard_model_parallel` did to a model: the rank's axes
    and groups, and which state_dict entries it split (``splits``, as
    :func:`model_parallel_shardings` gives them).  Kept on the model as
    ``model.model_axis``; a deep copy of the model shares it."""

    def __init__(self, axes, splits: Dict[str, Optional[int]]):
        self.axes = axes
        self.splits = splits

    def __deepcopy__(self, memo):
        return self

    def split(self, name: str) -> bool:
        return self.splits.get(name) is not None

    def _optimizer_names(self, state) -> Dict[int, str]:
        """The optimizer's state_dict index -> parameter name."""
        names = {id(p): n for n, p in state.model.named_parameters()}
        return {i: names[id(p)] for i, p in enumerate(
            p for g in state.optimizer.param_groups for p in g["params"])}

    def _map(self, state, payload: dict, fn) -> dict:
        """``payload`` (a checkpoint's dict) with ``fn`` applied to each
        split tensor: model entries, EMA entries, optimizer state."""
        out = dict(payload)
        out["model"] = {k: fn(v) if self.split(k) else v
                        for k, v in payload["model"].items()}
        if payload.get("ema") is not None:
            out["ema"] = {k: fn(v) if self.split(k) else v
                          for k, v in payload["ema"].items()}
        opt = payload.get("optimizer")
        if opt is not None and state.optimizer is not None:
            names = self._optimizer_names(state)
            out["optimizer"] = dict(opt, state={
                i: {k: fn(v) if torch.is_tensor(v) and v.dim() >= 1
                    and self.split(names[i]) else v for k, v in s.items()}
                for i, s in opt["state"].items()})
        return out

    @torch.no_grad()
    def whole(self, state) -> dict:
        """The state's checkpoint dict with every split tensor gathered
        over the model group (a collective: every rank of the group calls
        it)."""
        opt = state.optimizer
        payload = {"model": state.model.state_dict(),
                   "optimizer": None if opt is None else opt.state_dict(),
                   "ema": state.ema_params, "step": int(state.step)}
        return self._map(state, payload,
                         lambda t: _gather_dim0(t, self.axes))

    def own(self, state, payload: dict) -> dict:
        """A whole checkpoint dict cut to this rank's slices."""
        return self._map(state, payload,
                         lambda t: _slice_dim0(t, self.axes))


def _attach(module: nn.Module, axes, slice_input: bool) -> None:
    group, m, j = axes.model_group, axes.model, axes.model_index

    def enter(mod, args):
        x = _ToModelGroup.apply(args[0], group)
        if slice_input:
            n = x.shape[1] // m
            x = x[:, j * n:(j + 1) * n]
        return (x, *args[1:])

    def leave(mod, args, out):
        return _GatherChannels.apply(out, group, m, j)

    module.register_forward_pre_hook(enter)
    module.register_forward_hook(leave)


def shard_model_parallel(mesh: Mesh, tree, min_dim: int = 8
                         ) -> Dict[str, Optional[int]]:
    """Split ``tree`` (a ``TrainState`` or a module) over the model axis
    by :func:`model_parallel_shardings`, in place: each split parameter
    and buffer keeps this rank's slice, and so do the state's EMA copy and
    the optimizer's state of that parameter; the layers holding them are
    hooked as the module docstring says.  Returns the split map.  Call it
    on every rank, after ``make_mesh(mesh)`` and after the state is
    replicated (``distributed.broadcast_state``)."""
    from objectdetectionpl_tpu_torch.nn.blocks import BatchNorm, Conv, ConvBN

    model = tree if isinstance(tree, nn.Module) else tree.model
    splits = model_parallel_shardings(mesh, model, min_dim)
    if mesh.model == 1:
        return splits
    axes = distributed.axes()
    if axes is None or (axes.data, axes.model) != tuple(mesh):
        raise ValueError(f"shard_model_parallel: the ranks are not laid out "
                         f"as {tuple(mesh)} (make_mesh first)")
    if getattr(model, "model_axis", None) is not None:
        raise ValueError("shard_model_parallel: the model is split already")

    # which modules hold split tensors, and where each is hooked
    owner = {}
    for name, mod in model.named_modules():
        if isinstance(mod, ConvBN) and splits.get(
                f"{name}.Conv_0.weight" if name else "Conv_0.weight") == 0:
            _attach(mod, axes, slice_input=False)
            owner[mod.Conv_0] = owner[mod.BatchNorm_0] = mod
        elif isinstance(mod, (Conv, BatchNorm)) and mod not in owner and any(
                splits.get(f"{name}.{k}" if name else k) == 0
                for k, _ in mod.named_parameters(recurse=False)):
            _attach(mod, axes, slice_input=isinstance(mod, BatchNorm))
            owner[mod] = mod
    held = {f"{n}.{k}" if n else k for n, mod in model.named_modules()
            if mod in owner
            for k, _ in list(mod.named_parameters(recurse=False))
            + list(mod.named_buffers(recurse=False))}
    stray = [k for k, d in splits.items() if d == 0 and k not in held]
    if stray:
        raise NotImplementedError(f"shard_model_parallel: split tensors "
                                  f"outside Conv/BatchNorm: {stray[:5]}")

    state = None if isinstance(tree, nn.Module) else tree
    params = dict(model.named_parameters())
    with torch.no_grad():
        if state is not None and state.optimizer is not None:
            for name, p in params.items():
                if splits[name] == 0:
                    for k, v in state.optimizer.state.get(p, {}).items():
                        if torch.is_tensor(v) and v.shape == p.shape:
                            state.optimizer.state[p][k] = _slice_dim0(v, axes)
        if state is not None and state.ema_params is not None:
            for name in state.ema_params:
                if splits[name] == 0:
                    state.ema_params[name] = _slice_dim0(
                        state.ema_params[name], axes)
        for name, t in list(params.items()) + list(model.named_buffers()):
            if splits[name] == 0:
                t.data = _slice_dim0(t.data, axes)
    model.model_axis = ModelAxis(axes, splits)
    return splits


def gather_state_dict(tree) -> Dict[str, torch.Tensor]:
    """The whole state_dict of a module or ``TrainState`` split by
    :func:`shard_model_parallel`: each split entry gathered over the
    rank's model group (a collective: every rank of the group calls it);
    an unsplit model's own state_dict."""
    model = tree if isinstance(tree, nn.Module) else tree.model
    axis = getattr(model, "model_axis", None)
    sd = model.state_dict()
    if axis is None:
        return sd
    with torch.no_grad():
        return {k: _gather_dim0(v, axis.axes) if axis.split(k) else v
                for k, v in sd.items()}
