"""Data parallelism: one process per card (``mesh.py``)."""

from .mesh import (COUNTS, data_parallel, global_count, init_distributed, mesh_from_config,
                   place_state, shard_batch)

__all__ = ["COUNTS", "data_parallel", "global_count", "init_distributed", "mesh_from_config",
           "place_state", "shard_batch"]
