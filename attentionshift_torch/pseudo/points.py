"""Fixed-shape random/strided point selection from eligibility masks.

Port of ``attentionshift_tpu/pseudo/points.py``. The random samplers
draw from a ``torch.Generator`` or take their draws as tensors, so tests
can hand them the JAX package's draws:

- ``sample_in_mask``: uniform with replacement (``u`` uniforms in [0, 1)),
- ``strided_in_mask``: deterministic raster-order stride,
- ``topk_in_mask``: Gumbel top-k, uniform without replacement
  (``gumbel`` noise over the flattened mask).

All work on a leading batch of masks: (B, H, W) -> (B, k, 2) int64
(row, col) coords plus the per-mask eligible count.
"""

from __future__ import annotations

import torch

__all__ = ["sample_in_mask", "strided_in_mask", "topk_in_mask"]


def _coords_of_flat(flat_idx: torch.Tensor, width: int) -> torch.Tensor:
    return torch.stack([flat_idx // width, flat_idx % width], dim=-1)


def _raster_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H*W) inclusive raster-order count of True pixels."""
    return torch.cumsum(mask.reshape(mask.shape[0], -1).long(), dim=1)


def sample_in_mask(mask: torch.Tensor, k: int, generator: torch.Generator | None = None,
                   u: torch.Tensor | None = None):
    """Draw k eligible pixels per mask uniformly with replacement.

    ``u``: optional (B, k) uniforms in [0, 1) replacing the generator's.
    With no eligible pixel the coords are all zero (callers branch on n).
    """
    b, h, w = mask.shape
    cnt = _raster_cumsum(mask)
    n = cnt[:, -1]
    if u is None:
        u = torch.rand((b, k), generator=generator, device=mask.device)
    r = torch.minimum((u * n.clamp_min(1)[:, None]).long(), n.clamp_min(1)[:, None] - 1)
    idx = torch.searchsorted(cnt, r + 1).clamp(0, h * w - 1)
    return _coords_of_flat(idx, w), n


def strided_in_mask(mask: torch.Tensor, k: int):
    """Pick k eligible pixels per mask at even raster-order strides
    (``arange(0, n, n // k)[:k]``, cyclic refill when n < k)."""
    b, h, w = mask.shape
    cnt = _raster_cumsum(mask)
    n = cnt[:, -1:]
    step = (n // k).clamp_min(1)
    ranks = torch.arange(k, device=mask.device)[None] * step
    ranks = torch.where(n > 0, ranks % n.clamp_min(1), 0)
    idx = torch.searchsorted(cnt, ranks + 1).clamp(0, h * w - 1)
    return _coords_of_flat(idx, w), n[:, 0]


def topk_in_mask(mask: torch.Tensor, k: int, generator: torch.Generator | None = None,
                 gumbel: torch.Tensor | None = None):
    """Draw up to k eligible pixels per mask uniformly without replacement.

    ``gumbel``: optional (B, H*W) Gumbel noise replacing the generator's.
    Slots beyond the eligible count repeat earlier draws cyclically.
    Returns (coords (B, k, 2), slot validity (B, k), n (B,)).
    """
    b, h, w = mask.shape
    flat = mask.reshape(b, -1)
    n = flat.sum(dim=1)
    if gumbel is None:
        u = torch.rand(flat.shape, generator=generator, device=mask.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    scores = torch.where(flat, gumbel.to(flat.device).float(), -torch.inf)
    # a stable sort ranks tied (ineligible, -inf) pixels by index, as the
    # JAX top-k does; the slots they fill are refilled or unused below
    idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    slot = torch.arange(k, device=mask.device)[None]
    valid = slot < n[:, None]
    refill = torch.where(n[:, None] > 0, slot % n.clamp_min(1)[:, None], 0)
    idx = torch.where(valid, idx, torch.gather(idx, 1, refill)).clamp(0, h * w - 1)
    return _coords_of_flat(idx, w), valid, n
