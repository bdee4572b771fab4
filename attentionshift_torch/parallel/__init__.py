"""Data, tensor, sequence and pipeline parallelism over process groups
(``mesh.py``, ``tp.py``, ``pp.py``; the collectives in ``collectives.py``)."""

from .mesh import (COUNTS, Mesh, batch_sharding, data_parallel, global_count, init_distributed,
                   make_mesh, mesh_from_config, place_state, replicate, shard_batch)
from .pp import gpipe, gpipe_aux, shard_stage_params, stack_stage_params
from .tp import shard_opt_state_tp, shard_params_tp, tp_spec_tree

__all__ = ["COUNTS", "Mesh", "batch_sharding", "data_parallel", "global_count",
           "init_distributed", "make_mesh", "mesh_from_config", "place_state", "replicate",
           "shard_batch", "gpipe", "gpipe_aux",
           "shard_stage_params", "stack_stage_params", "shard_opt_state_tp", "shard_params_tp",
           "tp_spec_tree"]
