"""Data parallelism: one process on one card until ROADMAP A10.

The port of ``objectdetectionpl_tpu/parallel/``'s ``data_shard``: the
Loader asks it for its shard of the train set.  torch.distributed (DDP,
the BN moments all-reduced, the rank's Loader shard) comes with A10.
"""

from __future__ import annotations

import os
from typing import Tuple


def data_shard() -> Tuple[int, int]:
    """(num_shards, shard_id) for this process's Loader: (1, 0).  Raises
    when the environment names more than one process (``WORLD_SIZE``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(f"WORLD_SIZE={world}: multi-process data "
                                  f"parallelism is not ported yet "
                                  f"(ROADMAP A10)")
    return 1, 0
