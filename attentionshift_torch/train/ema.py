"""EMA teacher: the momentum teacher-student train step.

Port of ``attentionshift_tpu/train/ema.py``: a momentum copy of the model
is updated after every optimizer step, and its backbone's outputs drive
the pseudo-label engine while the student learns (the detector's
``teacher=`` input).

The teacher is a second module of the same architecture (a deep copy of
the student). Its backbone forward runs without a graph and reduces
nothing, so it issues no collective under a process group.
"""

from __future__ import annotations

from typing import Callable

import torch

from .state import TrainState
from .step import make_train_step

__all__ = ["ema_update", "make_train_step_ts"]


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module,
               momentum: float = 0.999) -> torch.nn.Module:
    """teacher <- m * teacher + (1 - m) * student over every floating
    parameter and buffer, in place (the JAX package maps the update over
    the whole variables tree, running statistics included); returns the
    teacher."""
    src = student.state_dict()
    for name, t in teacher.state_dict().items():
        if t.is_floating_point():
            t.copy_(t * momentum + src[name].to(t.dtype) * (1.0 - momentum))
    return teacher


def make_train_step_ts(model, momentum: float = 0.999, group=None) -> Callable:
    """The teacher-student train step: (state, teacher, batch,
    generator=None, loss_enable=1.0, draws=None, drop_masks=None) ->
    (state, teacher, metrics), with ``make_train_step``'s metrics and
    process-group semantics. The teacher's ``backbone_forward`` feeds the
    student's pseudo-label engine; after the optimizer step the teacher
    moves toward the student by ``ema_update``."""
    step = make_train_step(model, group)

    def train_step(state: TrainState, teacher, batch: dict, generator=None, loss_enable=1.0,
                   draws=None, **kw):
        teacher_out = teacher.backbone_forward(batch["img"])
        state, metrics = step(state, batch, generator=generator, loss_enable=loss_enable,
                              draws=draws, teacher=teacher_out, **kw)
        return state, ema_update(teacher, state.model, momentum), metrics

    return train_step
