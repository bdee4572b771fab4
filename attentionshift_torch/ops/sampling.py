"""Bilinear point sampling (``mmcv.ops.point_sample`` semantics).

Port of ``attentionshift_tpu/ops/sampling.py``: ``F.grid_sample`` with
``align_corners=False`` and zero padding, written as four gathered
corners so it is differentiable in the features and matches the JAX
package corner for corner.
"""

from __future__ import annotations

import torch

__all__ = ["point_sample"]


def point_sample(feats: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """feats (N, C, H, W), points (N, P, 2) xy in [0, 1] -> (N, C, P)."""
    n, c, h, w = feats.shape
    grid = points * 2.0 - 1.0
    x = ((grid[..., 0] + 1.0) * w - 1.0) / 2.0
    y = ((grid[..., 1] + 1.0) * h - 1.0) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    flat = feats.reshape(n, c, h * w)

    def corner(yi, xi, wgt):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # (N, P)
        vals = torch.gather(flat, 2, lin[:, None, :].expand(n, c, -1))
        return vals * (wgt * ok)[:, None, :].to(vals.dtype)

    return (corner(y0i, x0i, (1 - dy) * (1 - dx)) + corner(y0i, x0i + 1, (1 - dy) * dx)
            + corner(y0i + 1, x0i, dy * (1 - dx)) + corner(y0i + 1, x0i + 1, dy * dx))
