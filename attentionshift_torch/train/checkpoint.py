"""Checkpoints: save/resume the whole TrainState, weight-only exports.

Port of ``attentionshift_tpu/train/checkpoint.py`` with the same names
and the same ``work_dir/epoch_N`` layout (per-epoch checkpoints,
auto-resume from the highest epoch, weight-only export for publishing).
The format is the port's own: one file written by ``torch.save`` that
holds tensors and plain Python only, so it loads with
``torch.load(weights_only=True)``:

    {"step": int, "epoch": int,
     "params": model.state_dict() (parameters and buffers, on the CPU),
     "opt_state": Optimizer.state_dict(),   # not in a weight-only export
     "extra": ...}                           # optional

An orbax checkpoint of the JAX package is read where JAX is installed
and converted: ``attentionshift_tpu.train.restore_params`` ->
``attentionshift_torch.convert.load_flax`` -> ``save_params`` (README).
"""

from __future__ import annotations

import os
import re

import torch

from .state import TrainState

__all__ = [
    "save_checkpoint",
    "latest_checkpoint",
    "restore_checkpoint",
    "restore_params",
    "save_params",
]


def _ckpt_path(work_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(work_dir), f"epoch_{epoch}")


def _cpu_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _write(path: str, payload: dict) -> str:
    """``torch.save`` to ``path`` atomically (a reader never sees half a file)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(work_dir: str, state: TrainState, extra: dict | None = None) -> str:
    """Write ``work_dir/epoch_N`` (N = state.epoch) atomically."""
    payload = dict(step=int(state.step), epoch=int(state.epoch), params=_cpu_state(state.model),
                   opt_state=state.optimizer.state_dict())
    if extra:
        payload["extra"] = extra
    return _write(_ckpt_path(work_dir, int(state.epoch)), payload)


def latest_checkpoint(work_dir: str) -> str | None:
    """auto_resume glob over ``work_dir/epoch_*`` (highest epoch wins)."""
    if not os.path.isdir(work_dir):
        return None
    best, best_ep = None, -1
    for name in os.listdir(work_dir):
        m = re.fullmatch(r"epoch_(\d+)", name)
        if m and int(m.group(1)) > best_ep:
            best_ep = int(m.group(1))
            best = os.path.join(os.path.abspath(work_dir), name)
    return best


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore a ``save_checkpoint`` file into ``state`` (same model and
    optimizer layout): parameters, buffers, optimizer moments and
    counters, step and epoch. The tensors keep their device."""
    saved = _read(path)
    state.model.load_state_dict(saved["params"], strict=True)
    state.optimizer.load_state_dict(saved["opt_state"])
    state.step, state.epoch = int(saved["step"]), int(saved["epoch"])
    return state


def restore_params(path: str) -> dict:
    """The model's parameters and buffers (a state dict under the port's
    names, CPU tensors) from a ``save_checkpoint`` file or a
    ``save_params`` export: no optimizer needed, whatever the training
    optimizer's layout (accumulation steps, non-finite guard, ...)."""
    return _read(path)["params"]


def save_params(path: str, params: dict) -> str:
    """Weight-only export of a state dict (`tools/model_converters/publish_model.py` analog)."""
    return _write(os.path.abspath(path), dict(params={k: v.detach().cpu().clone()
                                                      for k, v in params.items()}))
