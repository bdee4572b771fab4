"""Tensor and sequence parallelism over the model group.

Port of ``attentionshift_tpu/parallel/tp.py``: Megatron column / row
parallelism of the transformer blocks over the ``model`` ranks of a
``parallel.mesh.Mesh``. The JAX package states it as ``NamedSharding``s
of the parameter tree and lets GSPMD insert the collectives; here the
parameters are sliced (``shard_params_tp``) and the blocks call the
collectives themselves (``models/layers.py``):

- ``attn.qkv`` and ``mlp.fc1`` are column-parallel: each rank holds the
  output features of its heads / of its slice of the hidden layer (and
  their biases);
- ``attn.proj`` and ``mlp.fc2`` are row-parallel: each rank holds the
  matching input features; the partial products are summed over the
  group, then the (replicated) bias is added once;
- the input of a column-parallel pair enters through ``copy_to_tp``
  (identity forward, all-reduce of the gradient backward), the output of
  a row-parallel one leaves through ``reduce_from_tp`` (all-reduce
  forward, identity backward).

Rules (``TP_RULES``) match the names ``attn.{qkv,proj}`` and
``mlp.{fc1,fc2}`` of the ViT backbone and of the ViT-decoder RoI heads
alike; the patch embedding's ``proj`` stays replicated. A module shards
as a whole or not at all: an attention whose head count the group size
does not divide, or a layer whose sharded dimension it does not divide,
stays replicated (the JAX rules' fallback).

The qkv split takes heads, not a contiguous chunk: the output index of
``qkv`` is ``s * C + h * d + j`` (s = q, k, v), so rank r holds, of each of
q, k and v, the heads ``[r H / tp, (r + 1) H / tp)``. (The JAX spec
``P(None, "model")`` cuts the flat 3C axis into contiguous chunks and
GSPMD reshards around the attention; the results agree, the layouts do
not.)

Sequence parallelism (``models/vit.py``'s ``sequence_parallel``,
Megatron-SP): between the backbone's blocks each rank holds ``ceil(T /
tp)`` tokens (the last shard padded), so the LayerNorms, residuals and
token-wise layers run on its shard. Before a column-parallel pair the
tokens are all-gathered (``gather_sp``: its backward reduce-scatters),
after a row-parallel one the partial sums are reduce-scattered
(``reduce_scatter_sp``: its backward all-gathers). The parameters applied
to the rank's tokens alone (LayerNorms, row-parallel biases, replicated
MLPs) see a partial gradient, which ``reduce_partial_grads`` sums over
the group. ``scatter_to_sp`` / ``gather_from_sp`` enter and leave the
sharded region from replicated code.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.nn as nn

from .collectives import all_gather, all_reduce, reduce_scatter

__all__ = ["TP_RULES", "TPContext", "SeqShard", "tp_spec_tree", "shard_params_tp",
           "shard_opt_state_tp", "shard_tensor", "unshard_tensor", "full_state_dict",
           "full_opt_state", "unshard_model", "full_train_state", "copy_to_tp", "reduce_from_tp",
           "gather_sp", "reduce_scatter_sp", "scatter_to_sp", "gather_from_sp",
           "partial_grad_names", "reduce_partial_grads"]

# (name suffix, sharded axis of the port's layout: a Dense weight is (out,
# in), so column-parallel is axis 0, row-parallel axis 1). Suffixes are
# scoped to the attn / mlp submodules: the patch embedding is named
# ``proj`` too and stays replicated
TP_RULES: list[tuple[tuple[str, ...], int]] = [
    (("attn", "qkv", "weight"), 0),
    (("attn", "qkv", "bias"), 0),
    (("attn", "proj", "weight"), 1),
    (("mlp", "fc1", "weight"), 0),
    (("mlp", "fc1", "bias"), 0),
    (("mlp", "fc2", "weight"), 1),
]


@dataclass(frozen=True)
class TPContext:
    """A model group: the group, its size and this rank's index in it."""

    group: object
    size: int
    rank: int

    def __deepcopy__(self, memo):  # a copied model keeps its group
        return self


@dataclass(frozen=True)
class SeqShard:
    """The token sharding of one sequence-parallel forward: ``t`` real
    tokens, ``ceil(t / size)`` per rank."""

    ctx: TPContext
    t: int

    @property
    def local(self) -> int:
        return -(-self.t // self.ctx.size)


def _spec_for(path: tuple[str, ...], shape: tuple[int, ...], tp: int) -> int | None:
    """The sharded axis of the parameter at ``path`` (None: replicated)."""
    for suffix, axis in TP_RULES:
        if path[-len(suffix):] == suffix:
            return axis if shape[axis] % tp == 0 else None
    return None


def _ruled(model: nn.Module, tp: int) -> dict:
    """owner -> {name: sharded axis or None} of the parameters that a rule
    matches, by the module that owns them (an ``attn`` or an ``mlp``)."""
    owners = {}
    for n, p in model.named_parameters():
        path = tuple(n.split("."))
        if any(path[-len(suffix):] == suffix for suffix, _ in TP_RULES):
            owners.setdefault(n.rsplit(".", 2)[0], {})[n] = _spec_for(path, tuple(p.shape), tp)
    return owners


def tp_spec_tree(model: nn.Module, tp: int) -> dict:
    """name -> sharded axis (or None) of every parameter of ``model``.
    Only modules that can run sharded (a ``tp`` attribute:
    ``layers.Attention`` and ``layers.Mlp``) shard, each as a whole, and an
    attention only when ``tp`` divides its heads (``tp_shardable``)."""
    specs = {n: None for n, _ in model.named_parameters()}
    for owner, ruled in _ruled(model, tp).items():
        mod = model.get_submodule(owner)
        fits = getattr(mod, "tp_shardable", lambda _: True)(tp)
        if hasattr(mod, "tp") and fits and None not in ruled.values():
            specs.update(ruled)
    return specs


def _is_qkv(name: str) -> bool:
    return name.endswith(("attn.qkv.weight", "attn.qkv.bias"))


def shard_tensor(name: str, t: torch.Tensor, axis: int, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the full parameter ``t``: its heads of each
    of q, k, v for ``attn.qkv``, else its chunk along ``axis``."""
    if _is_qkv(name):
        parts = t.reshape(3, t.shape[0] // 3, *t.shape[1:]).chunk(tp, dim=1)[rank]
        return parts.reshape(-1, *t.shape[1:]).contiguous()
    return t.chunk(tp, dim=axis)[rank].contiguous()


def unshard_tensor(name: str, shards: list, axis: int) -> torch.Tensor:
    """The full parameter from every rank's shard (``shard_tensor``'s
    inverse)."""
    if _is_qkv(name):
        parts = [s.reshape(3, s.shape[0] // 3, *s.shape[1:]) for s in shards]
        full = torch.cat(parts, dim=1)
        return full.reshape(-1, *full.shape[2:])
    return torch.cat(shards, dim=axis)


def shard_params_tp(model: nn.Module, mesh) -> dict:
    """Replace each parameter that ``tp_spec_tree`` shards by this rank's
    shard, in place, and hand the model group to the modules that run
    sharded (and to any module with a ``tp`` attribute, e.g. the ViT for
    its sequence parallelism). Returns the specs (kept on the model as
    ``tp_specs``)."""
    ctx = TPContext(mesh.model_group, mesh.model, mesh.model_index)
    specs = tp_spec_tree(model, ctx.size)
    owners = set(_ruled(model, ctx.size))
    with torch.no_grad():
        for name, axis in specs.items():
            if axis is None:
                continue
            owner, leaf = name.rsplit(".", 1)
            mod = model.get_submodule(owner)
            p = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(shard_tensor(name, p.data, axis, ctx.rank, ctx.size),
                                            requires_grad=p.requires_grad))
    for mname, mod in model.named_modules():
        if not hasattr(mod, "tp"):
            continue
        # an attention or MLP runs sharded only if its parameters are
        if mname in owners and not any(a is not None and n.startswith(f"{mname}.")
                                       for n, a in specs.items()):
            continue
        mod.tp = ctx
    model.tp_specs = specs
    return specs


def shard_opt_state_tp(optimizer, model: nn.Module, specs: dict, mesh) -> None:
    """Point ``optimizer`` at the sharded parameters of ``model`` and slice
    their moments (and gradient accumulator) as the parameters, as the JAX
    package places the optimizer state with the parameter specs; counters
    stay replicated. The optimizer learns the model group, for its global
    gradient norm and its non-finite guard."""
    params = dict(model.named_parameters())
    for i, name in enumerate(optimizer.names):
        axis = specs.get(name)
        optimizer.params[i] = params[name]
        if axis is None:
            continue
        for key in ("mu", "nu", "acc"):
            ts = getattr(optimizer, key)
            if ts is not None:
                ts[i] = shard_tensor(name, ts[i], axis, mesh.model_index, mesh.model)
    optimizer.tp_group = mesh.model_group
    optimizer.sharded = [specs.get(n) is not None for n in optimizer.names]


def _gather_full(name: str, t: torch.Tensor, axis: int, ctx: TPContext) -> torch.Tensor:
    shards = all_gather(t.detach().contiguous()[None], ctx.group, dim=0).unbind(0)
    return unshard_tensor(name, list(shards), axis)


def full_state_dict(model: nn.Module) -> dict:
    """The state dict of a ``shard_params_tp`` model with every sharded
    parameter gathered to its full shape (a collective: every rank of the
    model group calls it)."""
    specs = getattr(model, "tp_specs", {})
    ctx = next((m.tp for m in model.modules() if getattr(m, "tp", None) is not None), None)
    out = {}
    for name, t in model.state_dict().items():
        axis = specs.get(name)
        out[name] = t if axis is None else _gather_full(name, t, axis, ctx)
    return out


def full_opt_state(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the sharded moments gathered (a
    collective, as ``full_state_dict``)."""
    specs = getattr(model, "tp_specs", {})
    ctx = next((m.tp for m in model.modules() if getattr(m, "tp", None) is not None), None)
    state = optimizer.state_dict()
    for key in ("mu", "nu", "acc"):
        if state[key] is None:
            continue
        for name, t in state[key].items():
            axis = specs.get(name)
            if axis is not None:
                dev = optimizer.params[optimizer.names.index(name)].device
                state[key][name] = _gather_full(name, t.to(dev), axis, ctx).cpu()
    return state


def unshard_model(model: nn.Module) -> nn.Module:
    """A copy of a ``shard_params_tp`` model with full parameters that runs
    without any collective (a collective: every rank of the model group
    calls it)."""
    full = full_state_dict(model)
    twin = copy.deepcopy(model)
    for mod in twin.modules():
        if hasattr(mod, "tp"):
            mod.tp = None
    with torch.no_grad():
        for name, axis in getattr(model, "tp_specs", {}).items():
            if axis is not None:
                owner, leaf = name.rsplit(".", 1)
                mod = twin.get_submodule(owner)
                setattr(mod, leaf, nn.Parameter(full[name].clone(),
                                                requires_grad=getattr(mod, leaf).requires_grad))
    twin.tp_specs = {}
    return twin


def full_train_state(state):
    """A ``TrainState`` over ``unshard_model(state.model)`` whose optimizer
    holds the full moments: what a checkpoint and an evaluation of a
    tensor-parallel run read (a collective, as ``full_state_dict``)."""
    from ..train.state import TrainState

    model = unshard_model(state.model)
    full = full_opt_state(state.optimizer, state.model)
    opt = copy.copy(state.optimizer)
    params = dict(model.named_parameters())
    opt.params = [params[n] for n in opt.names]
    for key in ("mu", "nu", "acc"):
        if full[key] is not None:
            setattr(opt, key, [full[key][n].to(p.device) for n, p in zip(opt.names, opt.params)])
    opt.tp_group, opt.sharded = None, [False] * len(opt.names)
    return TrainState(model, opt, state.step, state.epoch)


# ------------------------------------------------------- Megatron regions


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.tp.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x.contiguous().clone(), tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Identity forward; the gradient is summed over the model group."""
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Sum over the model group forward; identity backward."""
    return _ReduceFromTP.apply(x, tp)


def _pad_tokens(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (B, T, ...) padded with zero tokens to ``n``."""
    if x.shape[1] == n:
        return x.contiguous()
    return torch.cat([x, x.new_zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]))], dim=1)


def _gather(x, seq: SeqShard):
    return all_gather(x.contiguous(), seq.ctx.group, dim=1)[:, :seq.t]


def _mine(x, seq: SeqShard):
    return _pad_tokens(x, seq.local * seq.ctx.size).chunk(seq.ctx.size, dim=1)[seq.ctx.rank]


def _scatter(x, seq: SeqShard):
    return reduce_scatter(_pad_tokens(x, seq.local * seq.ctx.size), seq.ctx.group, dim=1)


class _GatherSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _gather(x, seq)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.seq), None


class _ReduceScatterSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _scatter(x, seq)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.seq), None


class _ScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _mine(x, seq).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.seq), None


class _GatherFromSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _gather(x, seq)

    @staticmethod
    def backward(ctx, g):
        return _mine(g, ctx.seq).contiguous(), None


def gather_sp(x: torch.Tensor, seq: SeqShard) -> torch.Tensor:
    """Token shards -> all T tokens, into a column-parallel layer: the
    gradient is reduce-scattered (each rank's heads add to every token)."""
    return _GatherSP.apply(x, seq)


def reduce_scatter_sp(x: torch.Tensor, seq: SeqShard) -> torch.Tensor:
    """A row-parallel layer's partial sums over all T tokens -> the summed
    token shard of this rank; the gradient is all-gathered."""
    return _ReduceScatterSP.apply(x, seq)


def scatter_to_sp(x: torch.Tensor, seq: SeqShard) -> torch.Tensor:
    """Replicated tokens -> this rank's shard (the last one padded with
    zeros); the gradient is all-gathered."""
    return _ScatterToSP.apply(x, seq)


def gather_from_sp(x: torch.Tensor, seq: SeqShard) -> torch.Tensor:
    """Token shards -> all T tokens, into replicated code: the gradient,
    the same on every rank, is sliced to the rank's shard."""
    return _GatherFromSP.apply(x, seq)


def partial_grad_names(model: nn.Module) -> list:
    """The parameters of ``model`` whose gradient each rank of a
    sequence-parallel forward takes over its own tokens only: in each
    block that ran sharded tokens (``blocks`` of a module whose
    ``sequence_parallel`` is on and that holds a model group), the
    LayerNorms, the row-parallel biases, and every parameter of an MLP
    that stayed replicated."""
    names = []
    for mname, mod in model.named_modules():
        if not (getattr(mod, "sequence_parallel", False) and getattr(mod, "tp", None)):
            continue
        for i, blk in enumerate(mod.blocks):
            pre = f"{mname}.blocks.{i}." if mname else f"blocks.{i}."
            own = [n for n, _ in blk.named_parameters()]
            names += [pre + n for n in own if n.startswith(("norm1.", "norm2."))]
            if blk.attn.tp is not None:
                names.append(pre + "attn.proj.bias")
            if blk.mlp.tp is not None:
                names.append(pre + "mlp.fc2.bias")
            else:
                names += [pre + n for n in own if n.startswith("mlp.")]
    return names


def reduce_partial_grads(names: list, grads: list, partial: set, tp: TPContext) -> list:
    """``grads`` (one per name) with the entries named in ``partial`` summed
    over the model group, in one all-reduce."""
    idx = [i for i, n in enumerate(names) if n in partial and grads[i] is not None]
    if not idx:
        return grads
    flat = all_reduce(torch.cat([grads[i].reshape(-1).float() for i in idx]), tp.group)
    out = list(grads)
    for i, f in zip(idx, flat.split([grads[i].numel() for i in idx])):
        out[i] = f.view_as(grads[i]).to(grads[i].dtype)
    return out
