"""Exact top-k SET selection in ascending-index order.

Port of ``attentionshift_tpu/ops/topk.py::top_k_set``. The JAX version
avoids a partial sort with a bitwise threshold search; what it returns is
kept here: the same SET as a stable descending top-k (ties at the k-th
value go to the lowest index, -0.0 ranks below +0.0, NaN is excluded by
contract), listed by ascending index. Built from a stable sort on the
monotone integer image of the float bits.
"""

from __future__ import annotations

import torch

__all__ = ["top_k_set", "top_k_stable"]


def _sortable(x: torch.Tensor) -> torch.Tensor:
    """Monotone map of float32 onto int64 (the radix trick: flip all bits
    of negatives, set the sign bit of the others), so -0.0 < +0.0."""
    bits = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(bits >> 31 == 1, 0xFFFFFFFF - bits, bits | 0x80000000)


def top_k_stable(scores: torch.Tensor, k: int):
    """``lax.top_k`` order: the k largest of a 1-D vector, descending, ties
    by lowest index. Returns (values, indices int64)."""
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    return scores[idx], idx


def top_k_set(scores: torch.Tensor, k: int):
    """Exact top-k of a 1-D NaN-free score vector, order-insensitive:
    (values, indices int32), both (k,), by ascending index."""
    n = scores.shape[0]
    if k >= n:
        return scores, torch.arange(n, dtype=torch.int32, device=scores.device)
    order = torch.sort(_sortable(scores), descending=True, stable=True).indices[:k]
    idx = torch.sort(order).values
    return scores[idx], idx.int()
