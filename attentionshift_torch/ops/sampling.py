"""Bilinear sampling: ``grid_sample`` and ``mmcv.ops.point_sample``.

Port of ``attentionshift_tpu/ops/sampling.py``: ``F.grid_sample``
semantics with zero padding, written as four gathered corners so it is
differentiable in the features and matches the JAX package corner for
corner. ``grid_sample_bilinear`` takes either ``align_corners`` mode;
``point_sample`` is ``align_corners=False``.
"""

from __future__ import annotations

import torch

__all__ = ["grid_sample_bilinear", "point_sample"]


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """[-1, 1] grid coordinate -> continuous pixel index."""
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _bilinear(flat: torch.Tensor, h: int, w: int, x: torch.Tensor, y: torch.Tensor):
    """flat (N, C, H*W), pixel coords x, y (N, P) -> (N, C, P) samples, zero
    outside the image."""
    n, c, _ = flat.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()

    def corner(yi, xi, wgt):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # (N, P)
        vals = torch.gather(flat, 2, lin[:, None, :].expand(n, c, -1))
        return vals * (wgt * ok)[:, None, :].to(vals.dtype)

    return (corner(y0i, x0i, (1 - dy) * (1 - dx)) + corner(y0i, x0i + 1, (1 - dy) * dx)
            + corner(y0i + 1, x0i, dy * (1 - dx)) + corner(y0i + 1, x0i + 1, dy * dx))


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor,
                         align_corners: bool = False) -> torch.Tensor:
    """Sample ``img`` (C, H, W) at ``grid`` (..., 2) of [-1, 1] xy coords ->
    (C, ...) samples, zero padding outside the image."""
    c, h, w = img.shape
    gshape = grid.shape[:-1]
    pts = grid.reshape(1, -1, 2)
    x = _unnormalize(pts[..., 0], w, align_corners)
    y = _unnormalize(pts[..., 1], h, align_corners)
    out = _bilinear(img.reshape(1, c, h * w), h, w, x, y)[0]
    return out.reshape((c,) + tuple(gshape))


def point_sample(feats: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """feats (N, C, H, W), points (N, P, 2) xy in [0, 1] -> (N, C, P)."""
    n, c, h, w = feats.shape
    grid = points * 2.0 - 1.0
    x = _unnormalize(grid[..., 0], w, False)
    y = _unnormalize(grid[..., 1], h, False)
    return _bilinear(feats.reshape(n, c, h * w), h, w, x, y)
