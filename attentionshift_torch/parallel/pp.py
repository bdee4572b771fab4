"""Pipeline parallelism (GPipe) over the model group.

Port of ``attentionshift_tpu/parallel/pp.py``. The block stack is split
into S stages, one per rank of the model group (S = its size), and M
microbatches stream through them: every rank runs the same schedule of
``M + S - 1`` steps, at step t stage s works on microbatch t - s (when it
is one), stage 0 ingests the microbatch, every other stage receives its
input from stage s - 1, and each stage sends its output to stage s + 1
(``collectives.send`` / ``recv``: through the host under gloo). The last
stage's outputs reach every rank with one broadcast (the JAX package's
closing ``psum``). The fill and drain bubble is (S - 1) / (M + S - 1) of
the schedule.

The JAX package stacks the stage parameters on a leading axis sharded
over the ``model`` axis (``stack_stage_params``, ``shard_stage_params``);
here the stacked tree is sliced to this rank's stage.

``gpipe_aux`` adds per-stage side outputs (captured attention, feature
taps) that stay with the stage that made them: no send moves them, as
the JAX docstring requires.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .collectives import broadcast, recv, send

__all__ = ["gpipe", "gpipe_aux", "stack_stage_params", "shard_stage_params"]


def stack_stage_params(per_stage: list) -> dict:
    """Stack S per-stage parameter dicts (name -> tensor) on a new
    leading axis."""
    return {name: torch.stack([p[name] for p in per_stage]) for name in per_stage[0]}


def shard_stage_params(stacked: dict, tp) -> dict:
    """This rank's stage of a stacked tree: the slice ``tp.rank`` of every
    leaf (``tp``: the model group, a ``parallel.tp.TPContext``)."""
    return {name: t[tp.rank] for name, t in stacked.items()}


def _schedule(stage_fn, params, x, tp, with_aux: bool):
    s, idx = tp.size, tp.rank
    m = x.shape[0]
    out = torch.zeros_like(x)
    auxs = [None] * m
    for t in range(m + s - 1):
        w = t - idx  # the microbatch this stage works on at step t
        if not 0 <= w < m:
            continue
        inp = x[w] if idx == 0 else recv(torch.empty_like(x[w]), idx - 1, tp.group)
        y = stage_fn(params, inp)
        if with_aux:
            y, auxs[w] = y
        y = y.to(x.dtype)
        if idx < s - 1:
            send(y, idx + 1, tp.group)
        else:
            out[w] = y
    return broadcast(out, s - 1, tp.group), auxs


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
          x: torch.Tensor, tp) -> torch.Tensor:
    """Run the ``tp.size`` stages of the model group over microbatches.

    ``stage_fn(params, mb) -> mb``: one stage on one microbatch (output
    shape and dtype those of the input); ``stage_params``: this rank's
    stage (``shard_stage_params``); x: (M, mb, ...), the same on every
    rank. Returns the (M, mb, ...) outputs on every rank."""
    if tp is None or tp.size == 1:
        return torch.stack([stage_fn(stage_params, mb) for mb in x])
    return _schedule(stage_fn, stage_params, x, tp, with_aux=False)[0]


def gpipe_aux(stage_fn: Callable[[Any, torch.Tensor], tuple], stage_params: Any,
              x: torch.Tensor, tp) -> tuple:
    """GPipe with per-stage side outputs that are not pipelined.

    ``stage_fn(params, mb) -> (mb_out, aux)``, aux a tuple of tensors.
    Returns (out (M, mb, ...) on every rank, aux of this rank's stage: a
    tuple of (M, *leaf) tensors, microbatch by microbatch)."""
    if tp is None or tp.size == 1:
        ys, auxs = zip(*(stage_fn(stage_params, mb) for mb in x))
        return torch.stack(ys), tuple(torch.stack(a) for a in zip(*auxs))
    out, auxs = _schedule(stage_fn, stage_params, x, tp, with_aux=True)
    return out, tuple(torch.stack(a) for a in zip(*auxs))
