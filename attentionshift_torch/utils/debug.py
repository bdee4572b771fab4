"""Numerical-safety utilities.

Port of ``attentionshift_tpu/utils/debug.py``. Replaces the reference's
NaN tripwire that dumps tensors and calls ``exit()`` mid-training
(`stdroi_point_deform_attn_reppoints.py:3498-3507`) with functional
guards: ``check_finite_losses`` raises with the offending keys on the
host, ``guard_losses`` zero-replaces non-finite loss terms (so one bad
batch cannot poison the optimizer state), and ``finite_or_dump`` saves
the array for post-mortem. Each takes tensors or floats.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["check_finite_losses", "guard_losses", "finite_or_dump"]


def check_finite_losses(losses: dict, step: int | None = None) -> None:
    """Host-side check; raises FloatingPointError naming bad keys."""
    bad = [k for k, v in losses.items() if not np.isfinite(float(v))]
    if bad:
        raise FloatingPointError(
            f"non-finite losses at step {step}: {bad} "
            f"({ {k: float(losses[k]) for k in bad} })"
        )


def guard_losses(losses: dict) -> dict:
    """Non-finite loss terms become 0 (gradient-safe: no gradient flows
    through a replaced term)."""
    out = {}
    for k, v in losses.items():
        t = torch.as_tensor(v)
        out[k] = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    return out


def finite_or_dump(x, name: str, dump_dir: str = "debug_dumps"):
    """If x has non-finite values, save it as ``dump_dir/name.npy`` and raise."""
    arr = x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if not np.isfinite(arr).all():
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(dump_dir, f"{name}.npy")
        np.save(path, arr)
        raise FloatingPointError(f"{name} has non-finite values; dumped to {path}")
    return x
