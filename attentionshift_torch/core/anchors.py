"""Anchor generation (mmdet v2 ``AnchorGenerator`` semantics).

Port of ``attentionshift_tpu/core/anchors.py``: scales [8], ratios
[0.5, 1, 2], strides [4, 8, 16, 32, 64]. Anchors are built with numpy at
static feature-map shapes, cached, and moved to the asked device once.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

__all__ = ["base_anchors", "grid_anchors", "grid_anchors_per_level"]


def base_anchors(stride: int, ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 scales: Sequence[float] = (8.0,), center_offset: float = 0.0) -> np.ndarray:
    """(A, 4) base anchors for one level (mmdet gen_base_anchors)."""
    w = h = float(stride)
    x_center = center_offset * w
    y_center = center_offset * h
    h_ratios = np.sqrt(np.asarray(ratios, np.float64))
    w_ratios = 1.0 / h_ratios
    ws = (w * w_ratios[:, None] * np.asarray(scales)[None, :]).reshape(-1)
    hs = (h * h_ratios[:, None] * np.asarray(scales)[None, :]).reshape(-1)
    return np.stack([x_center - 0.5 * ws, y_center - 0.5 * hs,
                     x_center + 0.5 * ws, y_center + 0.5 * hs], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _grid_anchors_cached(feat_hw, strides, ratios, scales, device) -> torch.Tensor:
    out = []
    for (fh, fw), stride in zip(feat_hw, strides):
        base = base_anchors(stride, ratios, scales)  # (A, 4)
        sx = np.arange(fw, dtype=np.float32) * stride
        sy = np.arange(fh, dtype=np.float32) * stride
        shift_x, shift_y = np.meshgrid(sx, sy)
        shifts = np.stack([shift_x.ravel(), shift_y.ravel(), shift_x.ravel(), shift_y.ravel()],
                          axis=-1)
        out.append((shifts[:, None, :] + base[None, :, :]).reshape(-1, 4))
    return torch.from_numpy(np.concatenate(out, axis=0)).to(device)


def grid_anchors(featmap_sizes, strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0),
                 scales=(8.0,), device="cpu") -> torch.Tensor:
    """All-level anchors concatenated: (sum_l fh*fw*A, 4) xyxy."""
    return _grid_anchors_cached(
        tuple(tuple(int(v) for v in s) for s in featmap_sizes), tuple(strides),
        tuple(float(r) for r in ratios), tuple(float(s) for s in scales), torch.device(device))


def grid_anchors_per_level(featmap_sizes, strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0),
                           scales=(8.0,), device="cpu") -> list[torch.Tensor]:
    """Per-level anchor lists (each (fh*fw*A, 4))."""
    return [grid_anchors([hw], [s], ratios, scales, device)
            for hw, s in zip(featmap_sizes, strides)]
