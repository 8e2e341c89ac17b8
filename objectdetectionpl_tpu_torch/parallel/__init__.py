"""Data parallelism over torch.distributed: the port of ``objectdetectionpl_tpu/parallel/``."""

from objectdetectionpl_tpu_torch.parallel.distributed import (  # noqa: F401
    data_shard, maybe_initialize, process_count, process_index)
from objectdetectionpl_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh)
