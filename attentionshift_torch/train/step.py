"""The train and eval steps.

Port of ``attentionshift_tpu/train/step.py``: ``make_train_step``, one
function that computes the losses, the gradients of their sum, and
applies the accumulating optimizer; ``make_refine_train_step``, the same
for the Mask R-CNN refinement stage (boxes, labels and masks instead of
points); ``make_eval_step``, single-scale inference; ``step_generator``,
the per-step source of random draws.

Under a process group the train step computes what the JAX step computes
over a data-sharded mesh: every loss over the global batch (its
normalisers summed over the ranks, ``parallel.mesh.global_count``), the
gradient of the global loss (the mean of the ranks' gradients, one
all-reduce per call, so that each micro-step of an accumulation window is
global too) and the global loss values as metrics.

Batch contract (leading dim = the rank's batch): img (B, H, W, 3),
gt_points (B, G, 2), gt_labels (B, G), gt_valid (B, G), img_wh (B, 2);
for the refinement step gt_boxes (B, G, 4) and gt_masks (B, G, H/s, W/s)
uint8 at the model's ``mask_stride`` s instead of gt_points.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..parallel.mesh import COUNTS, data_parallel
from .state import TrainState

__all__ = ["make_train_step", "make_refine_train_step", "make_eval_step", "step_generator"]


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The generator of one train step's draws on ``device``, seeded from
    (seed + 1, step, rank): the twin of ``fold_in(PRNGKey(seed + 1),
    state.step)`` (`tools/train.py:257`, `train/step.py:33`), so that a
    resumed run draws what an unbroken one draws. Each rank draws for its
    own images."""
    gen = torch.Generator(device=device)
    return gen.manual_seed(((seed + 1) * 65536 + rank) * 2**32 + step)


def _mean_over_ranks(tensors, group) -> list:
    """One all-reduce of the tensors flattened together (f32): the mean
    over the ranks, each tensor in its own shape."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_train_step(model, group=None) -> Callable:
    """Build the train step for an ``AttnShiftDetector``-like model.

    The returned fn: (state, batch, generator=None, loss_enable=1.0,
    draws=None, drop_masks=None, teacher=None) -> (state, metrics).
    ``generator`` (on the model's device) feeds every random draw of the
    step; ``draws`` and ``drop_masks`` hand the draws in instead, and
    ``teacher`` an EMA teacher's backbone outputs (see the model's
    ``forward`` and ``train.ema``). Metrics are the model's losses plus ``loss_total``,
    the sum of the values whose key starts with ``loss``, detached.

    ``group``: a process group of data-parallel ranks, each with its own
    batch; losses, gradients and metrics are then those of the global
    batch. Without one the step runs no collective.
    """
    def forward(batch, generator, loss_enable, draws, drop_masks=None, teacher=None):
        return model(batch["img"], batch["gt_points"], batch["gt_labels"], batch["gt_valid"],
                     batch["img_wh"], loss_enable=loss_enable, teacher=teacher,
                     generator=generator, draws=draws, drop_masks=drop_masks)

    return _make_step(model, group, forward)


def make_refine_train_step(model, group=None) -> Callable:
    """Build the train step for a ``MaskRCNN`` (the refinement stage):
    (state, batch, generator=None, loss_enable=1.0, draws=None) ->
    (state, metrics), with ``make_train_step``'s metrics, process-group
    semantics (the RCNN sample count and the mask normaliser summed over
    the ranks) and gradients of the trainable parameters only (the frozen
    ResNet stages have none)."""

    def forward(batch, generator, loss_enable, draws):
        return model(batch["img"], batch["gt_boxes"], batch["gt_labels"], batch["gt_masks"],
                     batch["gt_valid"], batch["img_wh"], loss_enable=loss_enable,
                     generator=generator, draws=draws)

    return _make_step(model, group, forward)


def _make_step(model, group, forward) -> Callable:
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: dict, generator=None, loss_enable=1.0, draws=None,
                   **kw):
        with data_parallel(group):
            losses, _ = forward(batch, generator, loss_enable, draws, **kw)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        grads = torch.autograd.grad(total, params, allow_unused=True)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_total"] = total.detach()
        if group is not None:
            grads = _mean_over_ranks([torch.zeros_like(p) if g is None else g
                                      for g, p in zip(grads, params)], group)
            COUNTS["gradients"] += 1
            names = sorted(metrics)
            metrics = dict(zip(names, _mean_over_ranks([metrics[k] for k in names], group)))
            COUNTS["metrics"] += 1
        state = state.apply_gradients(grads)
        return state, metrics

    return train_step


def make_eval_step(model) -> Callable:
    """Single-scale inference step: (img, img_wh) -> ``TestOutputs``.

    The port's model owns its parameters, so the step takes none (the
    JAX step is ``(params, img, img_wh)``). It builds no graph.
    """

    def eval_step(img, img_wh):
        return model.simple_test(img, img_wh)

    return eval_step
