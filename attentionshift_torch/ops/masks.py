"""Mask-map utilities: box rasterisation and min-pool erosion.

Port of ``box2mask`` and ``corrosion`` from
``attentionshift_tpu/ops/masks.py`` (the slice's users; ``expansion``
and ``paste_masks`` come with the test path).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["box2mask", "corrosion"]


def box2mask(bboxes: torch.Tensor, img_size: tuple[int, int], default_val: float = 0.5) -> torch.Tensor:
    """Rasterise (N, 4) xyxy boxes into (N, H, W): 1.0 inside (integer
    crop ``[int(y1):int(y2+1), int(x1):int(x2+1)]``), ``default_val``
    outside."""
    h, w = img_size
    ys = torch.arange(h, dtype=torch.float32, device=bboxes.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=bboxes.device)[None, None, :]
    b = torch.floor(bboxes.float())
    x1, y1, x2, y2 = (b[:, i, None, None] for i in range(4))
    inside = (xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)
    return torch.where(inside, 1.0, float(default_val))


def corrosion(cam: torch.Tensor, corr_size: int = 11) -> torch.Tensor:
    """Min-pool erosion with SAME padding over the last two axes
    (``-F.max_pool2d(-cam, k, 1, k // 2)``; out-of-range cells ignored)."""
    lead = cam.shape[:-2]
    x = -cam.reshape(-1, 1, *cam.shape[-2:])
    pad = corr_size // 2
    x = F.max_pool2d(x, (corr_size, 1), stride=1, padding=(pad, 0))
    x = F.max_pool2d(x, (1, corr_size), stride=1, padding=(0, pad))
    return (-x).reshape(*lead, *cam.shape[-2:])
