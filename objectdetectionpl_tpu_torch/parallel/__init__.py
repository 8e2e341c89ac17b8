"""Data and model parallelism over torch.distributed: the port of ``objectdetectionpl_tpu/parallel/``."""

from objectdetectionpl_tpu_torch.parallel.distributed import (  # noqa: F401
    data_shard, maybe_initialize, process_count, process_index)
from objectdetectionpl_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, gather_state_dict, make_mesh, model_parallel_shardings,
    shard_model_parallel)
