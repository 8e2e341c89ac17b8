"""The ('data', 'model') mesh: the port of ``objectdetectionpl_tpu/parallel/mesh.py``.

In the JAX package a mesh is an array of devices that sharding
annotations refer to.  Here a rank is a device and the data axis is the
process group, so the mesh is its two axis sizes, checked against the
group: every rank on 'data', 'model' of size 1.  The model axis (JAX's
``model_parallel_shardings``) is ROADMAP A12.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

from objectdetectionpl_tpu_torch.parallel.distributed import process_count


class Mesh(NamedTuple):
    data: int
    model: int


def make_mesh(shape: Optional[Sequence[int]] = None) -> Mesh:
    """``shape`` (data, model), default all ranks on 'data'.  A model axis
    above 1 raises NotImplementedError, a data axis other than the world
    size ValueError."""
    world = process_count()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"mesh shape {shape}: expected (data, model)")
    data, model = shape
    if model > 1:
        raise NotImplementedError(f"mesh shape {shape}: a model axis is not "
                                  f"ported yet (ROADMAP A12)")
    if data != world:
        raise ValueError(f"mesh shape {shape} needs {data} ranks on 'data', "
                         f"the process group has {world}")
    return Mesh(data, model)
