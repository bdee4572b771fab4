"""The collectives of the parallel paths, for the backend that runs them.

``nccl`` takes CUDA tensors for every collective. ``gloo`` is the CPU
backend, and the one that runs several ranks on ONE card (NCCL refuses
two ranks on one device); it takes CUDA tensors for few of its
collectives, and for none of ``send``, ``recv`` or ``reduce_scatter``. So
the rule is chosen once, from the group's backend name: under ``gloo`` a
CUDA tensor is copied to the host, reduced or moved there, and copied
back; under ``nccl`` (and for CPU tensors) the collective takes the
tensor as it is. ``STAGING`` counts the staged calls, their bytes and the
milliseconds of their host copies (the wait for the card's queue before
each copy to the host included) and of the collectives themselves.

``reduce_scatter`` under ``gloo`` is an all-reduce and a slice (older
gloo builds have no reduce-scatter); under ``nccl`` it is
``reduce_scatter_tensor``. Ranks in ``send`` / ``recv`` are ranks of the
group.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

__all__ = ["STAGING", "all_reduce", "all_gather", "reduce_scatter", "broadcast", "send", "recv",
           "reset_staging"]

# staged calls: "calls", "bytes", "copy_ms" (host copies), "collective_ms"
STAGING: collections.Counter = collections.Counter()


def reset_staging() -> None:
    STAGING.clear()


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _Host:
    """``with _Host(group, t) as h``: ``h`` is ``t`` itself, or its host
    copy under gloo; on exit the host copy is written back into ``t``
    (when ``write_back``)."""

    def __init__(self, group, t: torch.Tensor, write_back: bool = True):
        self.t, self.write_back = t, write_back
        self.stage = _staged(group, t)

    def __enter__(self) -> torch.Tensor:
        if not self.stage:
            return self.t
        torch.cuda.synchronize(self.t.device)
        t0 = time.perf_counter()
        self.h = self.t.detach().cpu()
        self.t1 = time.perf_counter()
        STAGING["calls"] += 1
        STAGING["bytes"] += self.t.numel() * self.t.element_size()
        STAGING["copy_ms"] += (self.t1 - t0) * 1e3
        return self.h

    def __exit__(self, *exc) -> None:
        if not self.stage or exc[0] is not None:
            return
        t2 = time.perf_counter()
        STAGING["collective_ms"] += (t2 - self.t1) * 1e3
        if self.write_back:
            self.t.copy_(self.h)
            torch.cuda.synchronize(self.t.device)
        STAGING["copy_ms"] += (time.perf_counter() - t2) * 1e3


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    with _Host(group, t) as h:
        dist.all_reduce(h, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the group's rank ``src`` on every rank, in place."""
    with _Host(group, t) as h:
        dist.broadcast(h, src=dist.get_global_rank(group, src), group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    with _Host(group, t, write_back=False) as h:
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h.contiguous(), group=group)
        out = torch.cat(parts, dim=dim)
    return out.to(t.device) if out.device != t.device else out


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The rank's chunk along ``dim`` of ``t`` summed over the group
    (``t.shape[dim]`` divisible by the group's size)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if dist.get_backend(group) == "gloo":
        full = all_reduce(t.clone(), group)
        return full.chunk(n, dim=dim)[r].contiguous()
    parts = t.movedim(dim, 0).contiguous()
    out = parts.new_empty((parts.shape[0] // n,) + tuple(parts.shape[1:]))
    dist.reduce_scatter_tensor(out, parts, group=group)
    return out.movedim(0, dim).contiguous()


def send(t: torch.Tensor, dst: int, group) -> None:
    """Send ``t`` to the group's rank ``dst`` (blocking)."""
    with _Host(group, t, write_back=False) as h:
        dist.send(h.contiguous(), dst=dist.get_global_rank(group, dst), group=group)


def recv(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Receive into ``t`` from the group's rank ``src``; returns ``t``."""
    with _Host(group, t) as h:
        dist.recv(h, src=dist.get_global_rank(group, src), group=group)
    return t
