"""The train and eval steps.

Port of ``attentionshift_tpu/train/step.py``: ``make_train_step``, one
function that computes the losses, the gradients of their sum, and
applies the accumulating optimizer; ``make_eval_step``, single-scale
inference.

Batch contract (leading dim = batch): img (B, H, W, 3), gt_points
(B, G, 2), gt_labels (B, G), gt_valid (B, G), img_wh (B, 2).
"""

from __future__ import annotations

from typing import Callable

import torch

from .state import TrainState

__all__ = ["make_train_step", "make_eval_step"]


def make_train_step(model) -> Callable:
    """Build the train step for an ``AttnShiftDetector``-like model.

    The returned fn: (state, batch, generator=None, loss_enable=1.0,
    draws=None, drop_masks=None) -> (state, metrics). ``generator`` (on
    the model's device) feeds every random draw of the step; ``draws``
    and ``drop_masks`` hand the draws in instead (see the model's
    ``forward``). Metrics are the model's losses plus ``loss_total``,
    the sum of the values whose key starts with ``loss``, detached.
    """
    params = [p for _, p in model.named_parameters()]

    def train_step(state: TrainState, batch: dict, generator=None, loss_enable=1.0,
                   draws=None, drop_masks=None):
        losses, _ = model(batch["img"], batch["gt_points"], batch["gt_labels"],
                          batch["gt_valid"], batch["img_wh"], loss_enable=loss_enable,
                          generator=generator, draws=draws, drop_masks=drop_masks)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        grads = torch.autograd.grad(total, params, allow_unused=True)
        state = state.apply_gradients(grads)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_total"] = total.detach()
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
