"""Optimizer: AdamW with per-ViT-block layer decay + grad accumulation.

Port of ``attentionshift_tpu/train/optim.py::build_optimizer``, the optax
chain written out as one ``Optimizer`` object over a model's named
parameters:

- optional clip by global norm;
- Adam moments (b1 0.9, b2 0.999, eps 1e-8, bias-corrected);
- decoupled weight decay 0.05, not for 1-D parameters, biases,
  ``*_token`` and ``*pos_embed``;
- per-parameter lr scale ``decay^(num_layers - layer_id - 1)`` with
  num_layers = depth + 2: layer 0 for patch embed / cls token / pos
  embed, i + 1 for block i, num_layers - 1 for everything else;
- step LR with linear warmup;
- gradient accumulation: the mean of k gradients, one update every k
  calls (``optax.MultiSteps``);
- the non-finite guard: a call whose gradients hold inf/NaN changes
  neither parameters nor optimizer state, up to ``skip_nonfinite`` times
  in a row, and is counted (``notfinite_count``, ``last_finite``,
  ``total_notfinite``).

``build_sgd_optimizer`` is the refinement stage's rule
(``build_sgd_optimizer`` of the JAX package, mmdet's ``SGD momentum=0.9
wd=1e-4``): coupled weight decay added to the gradient, then the
momentum trace ``m = g + momentum * m`` and the step ``-lr * m``
(``add_decayed_weights`` -> ``trace`` -> ``scale_by_learning_rate``), on
the same schedule, clip, accumulation and non-finite guard, inside the
same ``Optimizer``.

Parameters and moments are f32 whatever the model's compute dtype.

Under tensor parallelism (``parallel.tp.shard_opt_state_tp``) the
optimizer holds the rank's shards and their moments, and learns the model
group (``tp_group``) and which parameters are sharded (``sharded``): the
global gradient norm sums the shards' squares over the group, and the
non-finite guard skips a call on every rank when one rank's shard is not
finite.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..parallel.collectives import all_reduce

__all__ = ["vit_layer_id", "lr_scales", "weight_decay_mask", "step_lr_schedule", "Optimizer",
           "build_optimizer", "build_sgd_optimizer"]


def vit_layer_id(name: str, num_layers: int) -> int:
    """Layer id of a parameter name such as ``backbone.blocks.3.attn.qkv.weight``
    (``get_num_layer_for_vit`` semantics)."""
    path = name.split(".")
    if path[0] != "backbone" or len(path) < 2:
        return num_layers - 1
    if path[1] in ("cls_token", "pos_embed") or path[1].startswith("patch_embed"):
        return 0
    if path[1] == "blocks":
        return int(path[2]) + 1
    return num_layers - 1


def lr_scales(names: Sequence[str], layer_decay: float, depth: int) -> dict[str, float]:
    """Per-parameter lr multiplier."""
    num_layers = depth + 2
    return {n: layer_decay ** (num_layers - vit_layer_id(n, num_layers) - 1) for n in names}


def _frozen(name: str, frozen_stages: int) -> bool:
    """Whether ``name`` lies in the ResNet stem or a stage up to
    ``frozen_stages`` (``backbone.conv1``, ``backbone.layer1.0...``)."""
    path = name.split(".")
    if frozen_stages < 0 or "backbone" not in path:
        return False
    rest = path[path.index("backbone") + 1:]
    if not rest:
        return False
    if rest[0] in ("conv1", "bn1"):
        return True
    if rest[0].startswith("layer") and rest[0][5:].isdigit():
        return int(rest[0][5:]) <= frozen_stages
    return False


def weight_decay_mask(named_params, frozen_stages: int = -1) -> dict[str, bool]:
    """True where weight decay applies (mmcv no-decay rules).

    ``frozen_stages``: also exclude the ResNet stem and the stages up to
    it, which ``models.resnet.ResNet`` freezes (a frozen parameter gets
    neither gradient nor decay, as torch's ``requires_grad=False``)."""
    mask = {}
    for name, p in named_params:
        leaf = name.rsplit(".", 1)[-1]
        mask[name] = not (p.dim() <= 1 or leaf == "bias" or name.endswith("_token")
                          or "pos_embed" in name or _frozen(name, frozen_stages))
    return mask


def step_lr_schedule(base_lr: float, steps_per_epoch: int, decay_epochs: Sequence[int] = (8, 11),
                     gamma: float = 0.1, warmup_iters: int = 500, warmup_ratio: float = 1e-3):
    """mmcv step policy with linear warmup: step count -> lr."""
    boundaries = [int(e * steps_per_epoch) for e in decay_epochs]

    def sched(step: int) -> float:
        if step < warmup_iters:
            return base_lr * (warmup_ratio + (1.0 - warmup_ratio) * step / warmup_iters)
        return base_lr * gamma ** sum(step >= bnd for bnd in boundaries)

    return sched


_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # Adam's moments and epsilon


class Optimizer:
    """The train recipe's optimizer over ``named_params`` (name, tensor):
    ``rule="adamw"`` (the AttnShift recipe) or ``"sgd"`` (the refinement
    stage's, with ``momentum``)."""

    def __init__(self, named_params, sched, weight_decay: float, scales: dict, wd_mask: dict,
                 accumulate_steps: int = 1, grad_clip: float | None = None,
                 skip_nonfinite: int | None = 100, rule: str = "adamw", momentum: float = 0.9):
        if rule not in ("adamw", "sgd"):
            raise ValueError(f"Optimizer: unknown rule {rule!r}")
        self.rule, self.momentum = rule, momentum
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.sched = sched
        self.scales = [scales[n] for n in self.names]
        self.decay = [weight_decay if wd_mask[n] else 0.0 for n in self.names]
        self.accumulate_steps, self.grad_clip = accumulate_steps, grad_clip
        self.skip_nonfinite = skip_nonfinite
        # Adam's first moment, or SGD's momentum trace
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = ([torch.zeros_like(p, dtype=torch.float32) for p in self.params]
                   if rule == "adamw" else None)
        self.acc = ([torch.zeros_like(p, dtype=torch.float32) for p in self.params]
                    if accumulate_steps > 1 else None)
        self.tp_group = None  # the model group under tensor parallelism
        self.sharded = [False] * len(self.params)
        self.count = 0  # optimizer updates made (Adam's and the schedule's count)
        self.mini_step = 0  # position inside the accumulation window
        self.notfinite_count = 0
        self.last_finite = True
        self.total_notfinite = 0

    _COUNTERS = ("count", "mini_step", "notfinite_count", "last_finite", "total_notfinite")

    def state_dict(self) -> dict:
        """Moments, accumulator and counters, tensors keyed by parameter
        name (copies on the CPU): what a checkpoint must carry to resume."""
        def named(ts):
            return {n: t.detach().cpu().clone() for n, t in zip(self.names, ts)}

        return dict(rule=self.rule, mu=named(self.mu),
                    nu=None if self.nu is None else named(self.nu),
                    acc=None if self.acc is None else named(self.acc),
                    **{k: getattr(self, k) for k in self._COUNTERS})

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s output into this optimizer's tensors
        (same parameter names and accumulation setting, else raises)."""
        if state.get("rule", "adamw") != self.rule:
            raise ValueError(f"Optimizer.load_state_dict: the checkpoint's rule "
                             f"{state.get('rule', 'adamw')!r} is not this optimizer's {self.rule!r}")
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("Optimizer.load_state_dict: the checkpoint's gradient accumulation "
                             "does not match this optimizer's")
        for key in ("mu", "nu", "acc"):
            if state[key] is None:
                continue
            if list(state[key]) != self.names:
                raise ValueError(f"Optimizer.load_state_dict: {key} holds other parameters")
            for t, saved in zip(getattr(self, key), state[key].values()):
                t.copy_(saved)
        for k in self._COUNTERS:
            setattr(self, k, state[k])

    @torch.no_grad()
    def step(self, grads) -> bool:
        """Apply one call's gradients (in ``named_params`` order; None
        counts as zero). Returns whether the parameters changed."""
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for g, p in zip(grads, self.params)]
        if self.skip_nonfinite is not None:
            bad = (~torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf"))))).sum()
            if self.tp_group is not None:
                bad = all_reduce(bad.float().reshape(1), self.tp_group)
            finite = not bool(bad.sum() > 0)
            self.last_finite = finite
            if finite:
                self.notfinite_count = 0
            else:
                self.notfinite_count += 1
                self.total_notfinite += 1
                if self.notfinite_count <= self.skip_nonfinite:
                    return False
        if self.acc is not None:
            # running mean of the window's gradients (the incoming tensors
            # are left alone: autograd may hand one tensor to two parameters)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step += 1
            if self.mini_step < self.accumulate_steps:
                return False
            grads = [a.clone() for a in self.acc]
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        if self.grad_clip is not None:
            norms = torch.stack(torch._foreach_norm(grads))
            norm = norms.norm()
            if self.tp_group is not None:
                mine = torch.tensor(self.sharded, device=norms.device)
                norm = (all_reduce((norms[mine] ** 2).sum().reshape(1), self.tp_group)
                        + (norms[~mine] ** 2).sum()).sqrt()[0]
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            grads = torch._foreach_mul(grads, scale)
        if self.rule == "adamw":
            self._adamw(grads)
        else:
            self._sgd(grads)
        return True

    def _sgd(self, grads) -> None:
        # coupled decay, then the momentum trace, then -lr (optax's
        # add_decayed_weights -> trace -> scale_by_learning_rate)
        upd = torch._foreach_add(grads, torch._foreach_mul(self.params, self.decay))
        torch._foreach_mul_(self.mu, self.momentum)
        torch._foreach_add_(self.mu, upd)
        lr = self.sched(self.count)
        self.count += 1
        torch._foreach_add_(self.params, torch._foreach_mul(self.mu, [-lr * s for s in self.scales]))

    def _adamw(self, grads) -> None:
        b1, b2 = _B1, _B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        lr = self.sched(self.count)
        self.count += 1
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, torch._foreach_mul(self.params, self.decay))
        torch._foreach_mul_(upd, [-lr * s for s in self.scales])
        torch._foreach_add_(self.params, upd)


def build_optimizer(model_or_named_params, base_lr: float = 1e-4, weight_decay: float = 0.05,
                    layer_decay: float = 0.75, depth: int = 12, steps_per_epoch: int = 1000,
                    decay_epochs: Sequence[int] = (8, 11), warmup_iters: int = 500,
                    warmup_ratio: float = 1e-3, accumulate_steps: int = 2,
                    grad_clip: float | None = None, skip_nonfinite: int | None = 100) -> Optimizer:
    """The full train-recipe optimizer for a model (or its named parameters)."""
    named = model_or_named_params
    if isinstance(named, torch.nn.Module):
        named = named.named_parameters()
    named = list(named)
    names = [n for n, _ in named]
    sched = step_lr_schedule(base_lr, steps_per_epoch, decay_epochs, warmup_iters=warmup_iters,
                             warmup_ratio=warmup_ratio)
    return Optimizer(named, sched, weight_decay, lr_scales(names, layer_decay, depth),
                     weight_decay_mask(named), accumulate_steps=accumulate_steps,
                     grad_clip=grad_clip, skip_nonfinite=skip_nonfinite)


def build_sgd_optimizer(model_or_named_params, base_lr: float = 0.02, momentum: float = 0.9,
                        weight_decay: float = 1e-4, steps_per_epoch: int = 1000,
                        decay_epochs: Sequence[int] = (8, 11), warmup_iters: int = 500,
                        warmup_ratio: float = 1e-3, accumulate_steps: int = 1,
                        grad_clip: float | None = None, frozen_stages: int = 1,
                        skip_nonfinite: int | None = 100) -> Optimizer:
    """The stock detection recipe (SGD with momentum, ``schedule_1x``) for
    the Mask R-CNN refinement stage, over a model's trainable parameters
    (or the given named parameters). ``frozen_stages`` must match the
    backbone's, so that frozen parameters get no decay."""
    named = model_or_named_params
    if isinstance(named, torch.nn.Module):
        named = [(n, p) for n, p in named.named_parameters() if p.requires_grad]
    named = list(named)
    sched = step_lr_schedule(base_lr, steps_per_epoch, decay_epochs, warmup_iters=warmup_iters,
                             warmup_ratio=warmup_ratio)
    return Optimizer(named, sched, weight_decay, {n: 1.0 for n, _ in named},
                     weight_decay_mask(named, frozen_stages), accumulate_steps=accumulate_steps,
                     grad_clip=grad_clip, skip_nonfinite=skip_nonfinite, rule="sgd",
                     momentum=momentum)
