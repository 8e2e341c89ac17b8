"""Multi-process data and model parallelism over ``torch.distributed``.

The port of ``objectdetectionpl_tpu/parallel/distributed.py``.  The JAX
package trains one function of the *global* batch: XLA inserts the
collectives that its sharding annotations ask for.  Here every rank runs
the step on its shard, and these collectives make the result the
global batch's:

- :func:`sum_with_grad` -- BatchNorm's moments (``nn/blocks.py``): an
  all-reduce SUM whose backward all-reduces the upstream gradient;
- :func:`batch_sum` and :func:`batch_world` -- the losses' normalisers
  (``ops/losses.py``), global counts while a train step runs
  (:func:`global_batch`), local otherwise (eval and predict);
- :func:`all_reduce_` -- one coalesced all-reduce SUM of the gradients
  (``train/step.py``): a flat buffer per dtype;
- :func:`broadcast_` -- rank 0's initial state (``train/loop.py``);
- :func:`all_true` -- one answer on every rank (``train/tune.py``);
- :func:`gather_rows` -- the rows of other ranks that mosaic reads
  (``data/augment.py``), over a second group of its own, since the
  augmentation runs in the Loader's thread while the step's collectives
  run in the main one.

The ranks form a ('data', 'model') mesh (:func:`set_mesh`, from
``parallel/mesh.py::make_mesh``): rank ``r`` sits at ``(r // model, r %
model)``, as JAX's row-major device array.  Everything above runs over the
rank's *data group* (the ranks of its model index), so the ranks of one
data index read one Loader shard, draw one augmentation and hold one
batch; the tuner's answer and the broadcasts of a replicated state run
over the world.  The model axis (``parallel/mesh.py``) gathers split
channels over the rank's *model group* (the ranks of its data index).
Without a mesh every rank is on 'data' and the data group is the world.

Every collective is an ``all_reduce`` or a ``broadcast``, which both NCCL
and gloo carry (gloo also for CUDA tensors), and each is the identity on
a group of one, so one process computes exactly what it did without a
group.  Inside :func:`local` the calling thread sees a data axis of one:
a step there runs no data collective (the tuner's memory probe, which may
fail on one rank alone); the model axis still gathers, since a split
layer cannot run without its other channels.
``maybe_initialize`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and is a
no-op without it.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = datetime.timedelta(seconds=600)   # a collective's wait

_aug_group = None           # the augmentation's group (gloo), the world's
_in_step = False            # set while a train step runs (global_batch)
_thread = threading.local()  # .alone: this thread is in local()


class Axes(NamedTuple):
    """This rank's place on a ('data', 'model') mesh and its groups."""
    data: int
    model: int
    data_index: int
    model_index: int
    data_group: object          # ranks of this model index
    model_group: object         # ranks of this data index
    aug_group: object           # the data group over gloo, for mosaic


_axes: Optional[Axes] = None    # None: every rank on 'data'
_mesh_groups: Dict[Tuple[int, int], Axes] = {}


def maybe_initialize(backend: Optional[str] = None) -> bool:
    """Join the process group that torchrun's environment describes; True
    when a group is up afterwards, False (and nothing done) without the
    environment.  ``backend`` None is NCCL when CUDA is present, else
    gloo.  A group that does not come up raises."""
    global _aug_group
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ENV):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=TIMEOUT)
    if dist.get_world_size() > 1:
        _aug_group = dist.new_group(backend="gloo")
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _aug_group, _axes
    if dist.is_initialized():
        dist.destroy_process_group()
    _aug_group = _axes = None
    _mesh_groups.clear()


def set_mesh(data: int, model: int) -> None:
    """Lay the ranks out as a (data, model) mesh, ``data * model`` the
    world size (checked by ``mesh.make_mesh``).  With ``model`` 1 every
    rank is on 'data' and the data group is the world, as without a mesh.
    Otherwise the groups of every row and column are made, by every rank
    in the same order (``dist.new_group`` requires it), once per shape."""
    global _axes
    if model == 1 or not dist.is_initialized():
        _axes = None
        return
    if (data, model) not in _mesh_groups:
        columns = [[j + model * i for i in range(data)] for j in range(model)]
        rows = [[i * model + j for j in range(model)] for i in range(data)]
        data_groups = [dist.new_group(c) for c in columns]
        model_groups = [dist.new_group(r) for r in rows]
        aug_groups = [dist.new_group(c, backend="gloo") for c in columns]
        i, j = divmod(dist.get_rank(), model)
        _mesh_groups[(data, model)] = Axes(
            data, model, i, j, data_groups[j], model_groups[i],
            aug_groups[j])
    _axes = _mesh_groups[(data, model)]


def axes() -> Optional[Axes]:
    """This rank's mesh axes and groups; None when every rank is on
    'data' (no mesh, a model axis of 1, or no process group)."""
    return _axes if dist.is_initialized() else None


def process_count() -> int:
    """The world size; 1 without a group, or inside :func:`local`."""
    if not dist.is_initialized() or getattr(_thread, "alone", False):
        return 1
    return dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if process_count() > 1 else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def data_shard() -> Tuple[int, int]:
    """(num_shards, shard_id) for this process's Loader: the data axis's
    size and this rank's index on it ((world size, rank) without a model
    axis), (1, 0) without a group or inside :func:`local`."""
    if process_count() == 1:
        return 1, 0
    a = axes()
    return (a.data, a.data_index) if a else (process_count(),
                                            process_index())


def _data_group():
    """The rank's data group (None: the world)."""
    a = axes()
    return a.data_group if a else None


def _scalar_device() -> torch.device:
    """Where a collective on the default group takes its host values: the
    current card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


@contextlib.contextmanager
def local():
    """The calling thread sees a world of one inside this context: every
    collective here is the identity, so a step run in it is the rank's
    own, whatever the other ranks do."""
    before, _thread.alone = getattr(_thread, "alone", False), True
    try:
        yield
    finally:
        _thread.alone = before


def all_true(flag: bool) -> bool:
    """True on every rank iff ``flag`` is true on every rank (one
    all-reduce MIN)."""
    if process_count() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_scalar_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


# --- the step's global batch ------------------------------------------------


@contextlib.contextmanager
def global_batch():
    """The losses normalise over the global batch inside this context:
    the train step's forward and backward run in it."""
    global _in_step
    before, _in_step = _in_step, True
    try:
        yield
    finally:
        _in_step = before


def batch_world() -> int:
    """Data shards that make up the batch: the data axis's size inside
    :func:`global_batch`, else 1."""
    return data_shard()[0] if _in_step else 1


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group inside :func:`global_batch` (no
    gradient; reduced in float64, exact for counts), else ``x`` itself."""
    if batch_world() == 1:
        return x
    total = x.detach().to(torch.float64)
    dist.all_reduce(total, group=_data_group())
    return total.to(x.dtype)


class _SumWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_with_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group; the gradient of each rank's input
    is the sum of the group's upstream gradients, since every rank's loss
    depends on the sum.  The identity on a data axis of one."""
    if data_shard()[0] == 1:
        return x
    return _SumWithGrad.apply(x, _data_group())


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict:
    groups: Dict = {}
    for t in tensors:
        if t is not None:
            groups.setdefault((t.dtype, t.device), []).append(t)
    return groups


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the data group in place: one all-reduce of a
    flat buffer per dtype (None entries skipped)."""
    if data_shard()[0] == 1:
        return
    for group in _by_dtype(tensors).values():
        flat = torch._utils._flatten_dense_tensors(group)
        dist.all_reduce(flat, group=_data_group())
        for t, r in zip(group, torch._utils._unflatten_dense_tensors(
                flat, group)):
            t.copy_(r)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Overwrite each tensor with global rank ``src``'s, in place, over
    ``group`` (default the world): one broadcast of a flat buffer per
    dtype."""
    if process_count() == 1:
        return
    for same in _by_dtype(tensors).values():
        flat = torch._utils._flatten_dense_tensors(same)
        dist.broadcast(flat, src, group=group)
        for t, r in zip(same, torch._utils._unflatten_dense_tensors(
                flat, same)):
            t.copy_(r)


def broadcast_value(value: Optional[float]) -> Optional[float]:
    """Rank 0's float on every rank (None stays None: every rank
    must pass None together)."""
    if value is None or process_count() == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=_scalar_device())
    dist.broadcast(t, 0)
    return float(t.item())


def broadcast_state(state) -> None:
    """Every rank's ``TrainState`` becomes rank 0's: parameters, BN
    statistics, the EMA copy, the step count and the optimizer's state on
    the model's device (step counts that the optimizer keeps on the host
    are equal on every rank by construction).  A state split over a model
    axis (``state.model_axis``) becomes instead that of data index 0 of
    the rank's model index, over its data group: the ranks of one model
    index hold the same slices."""
    a = axes() if state.model_axis is not None else None
    dev = next(state.model.parameters()).device
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    if state.ema_params is not None:
        tensors += list(state.ema_params.values())
    tensors.append(state.step)
    if state.optimizer is not None:
        tensors += [v for s in state.optimizer.state.values()
                    for v in s.values()
                    if torch.is_tensor(v) and v.device == dev]
    if a is None:
        broadcast_(tensors)
    elif a.data > 1:     # data index 0 of model index j is global rank j
        broadcast_(tensors, a.model_index, a.data_group)


@torch.no_grad()
def gather_rows(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each rank's ``[b, ...]`` tensors -> the global ``[R*b, ...]`` ones,
    ranks in order, on every rank: each rank writes its rows into a zeroed
    buffer and one float32 all-reduce SUM (over the augmentation's own
    group) adds them up, which is exact (x + 0 == x; integer and bool
    values below 2**24 pass through float32 unchanged).  Equal ``b`` on
    every rank."""
    R, r = data_shard()
    if R == 1:
        return list(tensors)
    a = axes()
    b = tensors[0].shape[0]
    sizes = [t[0].numel() for t in tensors]
    flat = torch.zeros((R, b, sum(sizes)), dtype=torch.float32,
                       device=tensors[0].device)
    flat[r] = torch.cat([t.reshape(b, -1).to(torch.float32)
                         for t in tensors], dim=1)
    dist.all_reduce(flat, group=a.aug_group if a else _aug_group)
    flat = flat.reshape(R * b, -1)
    out, at = [], 0
    for t, n in zip(tensors, sizes):
        out.append(flat[:, at:at + n].reshape(R * b, *t.shape[1:])
                   .to(t.dtype))
        at += n
    return out
