"""TrainState: model, optimizer and the step/epoch counters.

Port of ``attentionshift_tpu/train/state.py``. PyTorch updates parameters
in place, so the state is a mutable holder and ``apply_gradients``
returns itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .optim import Optimizer

__all__ = ["TrainState"]


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0  # calls of the train step (micro-steps)
    epoch: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer) -> "TrainState":
        return cls(model=model, optimizer=optimizer)

    def apply_gradients(self, grads) -> "TrainState":
        self.optimizer.step(grads)
        self.step += 1
        return self

    def next_epoch(self) -> "TrainState":
        self.epoch += 1
        return self
