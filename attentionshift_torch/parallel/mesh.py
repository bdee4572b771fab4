"""Data parallelism over processes: one rank per card.

Port of the data-parallel part of ``attentionshift_tpu/parallel/mesh.py``.
The JAX package runs one process per host that drives every local chip
through a ``(data, model)`` mesh; XLA's partitioner makes every loss of
the jitted step a loss over the GLOBAL batch (it sums each normaliser
across the batch shards) and inserts the gradient all-reduce. Here each
rank is one process on one card (``torchrun --nproc_per_node N``), so the
train step does both explicitly under a process group:

- ``global_count`` turns a loss normaliser counted over the rank's batch
  into its share of the count over the global batch;
- ``train.step.make_train_step(model, group)`` averages the gradients and
  the loss values over the ranks.

``data.batch_size`` is per rank, as it is per host in the JAX package; a
host with N cards runs N ranks, so one host's batch is N x batch_size.
Tensor, sequence and pipeline parallelism are not ported
(``mesh_from_config`` raises).
"""

from __future__ import annotations

import collections
import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["COUNTS", "init_distributed", "mesh_from_config", "place_state", "shard_batch",
           "data_parallel", "global_count"]

# all-reduces made by the data-parallel train step, by kind: "normalisers"
# (one per loss normaliser), "gradients" and "metrics" (one each per step)
COUNTS: collections.Counter = collections.Counter()

# the process group of the train step running now (``data_parallel``). It
# is process-global and not re-entrant across models: any forward that
# runs inside the block, of any model, reduces its loss normalisers over
# the group
_GROUP = None


def init_distributed(device: torch.device) -> tuple[int, int, torch.device]:
    """Join the process group that ``torchrun`` describes: (rank, world
    size, this rank's device).

    Reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
    (and ``LOCAL_RANK`` for the card); ``nccl`` on the card, ``gloo`` on
    the CPU. Without ``WORLD_SIZE`` the process is rank 0 of 1 and builds
    no group. A group that already exists is joined as it is.
    """
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif "WORLD_SIZE" not in os.environ:
        return 0, 1, device
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        addr = os.environ.get("MASTER_ADDR", "localhost")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
                                rank=rank, world_size=world)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return rank, world, device


def mesh_from_config(parallel_cfg: dict | None, world_size: int) -> int:
    """The data-parallel degree of a config's ``parallel`` block: every
    rank holds a replica, so it is the world size. ``data``, when given,
    must equal it; ``model > 1`` (tensor parallelism) and
    ``sequence_parallel`` are not ported."""
    cfg = dict(parallel_cfg or {})
    if int(cfg.get("model", 1)) > 1:
        raise NotImplementedError("parallel.model > 1 (tensor parallelism) is not ported yet")
    if cfg.get("sequence_parallel"):
        raise NotImplementedError("parallel.sequence_parallel is not ported yet")
    data = cfg.get("data")
    if data is not None and int(data) != world_size:
        raise ValueError(f"parallel.data={data} but {world_size} ranks run: one replica per rank")
    return world_size


def place_state(state, group=None):
    """Broadcast every parameter and buffer of ``state.model`` from rank 0
    (the JAX package's replication), in place; returns ``state``."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return state
    with torch.no_grad():
        for t in state.model.state_dict().values():
            dist.broadcast(t, src=0, group=group)
    return state


def shard_batch(batch: dict, device) -> dict:
    """The rank's numpy batch as tensors on its device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, ``global_count`` reduces over ``group``'s ranks."""
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
    total = n.detach().float().clone()
    dist.all_reduce(total, group=_GROUP)
    COUNTS["normalisers"] += 1
    return total.clamp_min(floor) / dist.get_world_size(_GROUP)
