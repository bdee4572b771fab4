"""The (data, model) layout of the ranks: data, tensor and sequence
parallelism over process groups.

Port of ``attentionshift_tpu/parallel/mesh.py``. The JAX package runs one
process per host that drives every local chip through a ``(data, model)``
mesh; XLA's partitioner makes every loss of the jitted step a loss over
the GLOBAL batch (it sums each normaliser across the batch shards),
inserts the gradient all-reduce, and shards the transformer kernels over
``model`` (``parallel/tp.py``). Here each rank is one process
(``torchrun --nproc_per_node N``), and ``Mesh`` lays the world out as
``data x model`` ranks, rank = d * model + m: the ranks that share a data
index d form one model group (tensor and sequence parallelism over their
``model`` ranks), the ranks that share a model index m one data group.
The train step works explicitly under them:

- ``global_count`` turns a loss normaliser counted over the replica's
  batch into its share of the count over the global batch, summed over
  the DATA group only (the loss is replicated over the model group, and a
  sum there would multiply it by ``model``);
- ``train.step.make_train_step(model, mesh)`` averages the gradients and
  the loss values over the data group (and, under sequence parallelism,
  first sums the gradients that each model rank took over its tokens
  alone over the model group).

``data.batch_size`` is per data replica, as it is per host in the JAX
package: the ranks of one model group take the same batch.
"""

from __future__ import annotations

import collections
import contextlib
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_reduce, broadcast

__all__ = ["COUNTS", "Mesh", "init_distributed", "make_mesh", "mesh_from_config", "place_state",
           "replicate", "batch_sharding", "shard_batch", "data_parallel", "global_count"]

# all-reduces made by the parallel train step, by kind: "normalisers" (one
# per loss normaliser), "gradients" and "metrics" over the data group,
# "sequence_gradients" over the model group (one each per step)
COUNTS: collections.Counter = collections.Counter()

# the process group of the train step running now (``data_parallel``). It
# is process-global and not re-entrant across models: any forward that
# runs inside the block, of any model, reduces its loss normalisers over
# the group
_GROUP = None


def init_distributed(device: torch.device) -> tuple[int, int, torch.device]:
    """Join the process group that ``torchrun`` describes: (rank, world
    size, this rank's device).

    Reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
    ``LOCAL_RANK`` (rank i takes card ``LOCAL_RANK`` modulo the host's
    count). The backend is ``ATTNSHIFT_DIST_BACKEND`` where it is set,
    else ``nccl`` on the card and ``gloo`` on the CPU: it is never guessed
    from the rank and card counts. Ranks that share a card (NCCL refuses
    two ranks on one device) ask for ``gloo``, and then every collective of
    a CUDA tensor is staged through the host (``collectives.py``). Without
    ``WORLD_SIZE`` the process is rank 0 of 1 and builds no group. A group
    that already exists is joined as it is.
    """
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif "WORLD_SIZE" not in os.environ:
        return 0, 1, device
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        backend = os.environ.get("ATTNSHIFT_DIST_BACKEND",
                                 "nccl" if device.type == "cuda" else "gloo")
        addr = os.environ.get("MASTER_ADDR", "localhost")
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
                                rank=rank, world_size=world)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return rank, world, device


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``data x model`` layout of the world
    (rank = d * model + m), with its two process groups: ``data_group``
    (the ``data`` ranks of model index m: the world when ``model`` is 1,
    None when ``data`` is 1 and ``model`` is not) and ``model_group`` (the
    ``model`` ranks of data index d; None when ``model`` is 1)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(data: int, model: int = 1) -> Mesh:
    """The ``data x model`` layout of the process group that this rank
    joined (one rank of 1 without one). Every rank must call it, in the
    same order: it makes the groups with ``dist.new_group``."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if data * model != world:
        raise ValueError(f"parallel: data={data} x model={model} != {world} ranks: one rank per "
                         f"(data, model) slot")
    if not grouped:
        return Mesh()
    rank = dist.get_rank()
    data_group = model_group = None
    if model == 1:
        data_group = dist.group.WORLD
    elif data == 1:
        model_group = dist.group.WORLD
    else:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == rank // model:
                model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == rank % model:
                data_group = g
    return Mesh(data, model, rank, data_group, model_group)


def mesh_from_config(parallel_cfg: dict | None, world_size: int) -> Mesh:
    """The mesh of a config's ``parallel`` block (all keys optional):

        parallel = dict(
            model=2,                # tensor-parallel ways (the model group)
            data=4,                 # data-parallel ways (default: the rest)
            sequence_parallel=True, # a model flag, plumbed in by the CLI
        )

    ``data x model`` must equal the world size: every rank holds one slot
    (so the JAX package's cap of ``data`` at a divisor of the batch, which
    leaves devices idle, has nothing to cap here: ``data.batch_size`` is
    per data replica)."""
    cfg = dict(parallel_cfg or {})
    model = int(cfg.get("model", 1))
    if model < 1 or world_size % model:
        raise ValueError(f"parallel.model={model} does not divide the {world_size} ranks")
    return make_mesh(int(cfg.get("data", world_size // model)), model)


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0, in
    place (the JAX package's full replication); returns ``module``."""
    if dist.is_available() and dist.is_initialized():
        with torch.no_grad():
            for t in module.state_dict().values():
                broadcast(t, 0, dist.group.WORLD)
    return module


def batch_sharding(mesh: Mesh) -> tuple[int, int]:
    """(index, count) of this rank's share of the global batch: its data
    index among the ``data`` replicas (the ranks of a model group share
    one)."""
    return mesh.data_index, mesh.data


def place_state(state, mesh: Mesh | None = None):
    """Replicate ``state.model`` from rank 0 (``replicate``); then, when
    the mesh has a model group, shard the transformer kernels and their
    optimizer moments over it (``parallel/tp.py``), as the JAX
    ``place_state`` does. Returns ``state``."""
    from .tp import shard_opt_state_tp, shard_params_tp

    replicate(state.model)
    if mesh is not None and mesh.model > 1:
        specs = shard_params_tp(state.model, mesh)
        shard_opt_state_tp(state.optimizer, state.model, specs, mesh)
    return state


def shard_batch(batch: dict, device) -> dict:
    """The rank's numpy batch as tensors on its device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, ``global_count`` reduces over ``group``'s ranks
    (the data group; None: no reduction)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def global_count(n: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """A loss normaliser: ``max(n, floor)`` for a count ``n`` over the
    rank's batch, outside a data-parallel step.

    Inside one (``data_parallel``), the rank's share ``max(N, floor) / W``
    of the count N summed over the W ranks: each rank's loss is then W
    times its part of the loss over the global batch, so that the mean
    over the ranks of the losses, and of their gradients, is the global
    loss and its gradient, as the JAX package computes them.
    """
    if _GROUP is None:
        return n.clamp_min(floor)
    total = all_reduce(n.detach().float().clone(), _GROUP)
    COUNTS["normalisers"] += 1
    return total.clamp_min(floor) / dist.get_world_size(_GROUP)
