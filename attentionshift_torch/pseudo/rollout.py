"""Attention rollout restricted to the point-token rows.

Port of ``attentionshift_tpu/pseudo/rollout.py``: with the augmented map
``Aug = (A + I) / rowsum(A + I)`` folded into the product,

    R_0 = rows(Aug[L-1]);   R_i = R_{i-1} @ Aug[L-1-i],

keeping only the (P, T) row block. Output index 0 is the last layer
alone, index L-1 the full product (the reference's ``reverse_joint``).
A plain matmul chain: the JAX package computes it outside any kernel.
"""

from __future__ import annotations

import torch

__all__ = ["attention_rollout_point_rows"]


def attention_rollout_point_rows(attns: torch.Tensor, num_points: int,
                                 assume_normalized: bool = False) -> torch.Tensor:
    """(L, B, T, T) mean-head attention, depth order -> (L, B, P, T) f32.

    ``assume_normalized``: rows of ``attns`` sum to 1 (softmax outputs),
    so ``rowsum(A + I) = 2`` exactly and the row-sum pass is skipped.
    """
    l, b, t, _ = attns.shape
    p = num_points

    def inv_rowsum(a, rows=None):
        n = p if rows is not None else t
        if assume_normalized:
            return torch.full((b, n), 0.5, device=a.device)
        af = a.float()
        s = (af[:, rows] if rows is not None else af).sum(-1)
        return 1.0 / (1.0 + s)

    last = attns[-1]
    w0 = inv_rowsum(last, rows=slice(t - p, t))
    eye_rows = torch.zeros((p, t), device=attns.device)
    eye_rows[torch.arange(p), torch.arange(t - p, t)] = 1.0
    r = (last[:, -p:, :].float() + eye_rows[None]) * w0[..., None]
    out = [r]
    for i in range(l - 2, -1, -1):
        a = attns[i]
        rw = r * inv_rowsum(a)[:, None, :]
        # operands in the stored dtype, as the JAX package contracts them
        r = torch.matmul(rw.to(a.dtype), a).float() + rw
        out.append(r)
    return torch.stack(out, dim=0)
