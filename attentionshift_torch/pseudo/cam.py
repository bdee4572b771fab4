"""CAM -> pseudo-box seeding (Stage A).

Port of ``normalize_cam``, ``norm_attns`` and ``bbox_from_labels_batch``
from ``attentionshift_tpu/pseudo/cam.py``: after connected-component
labelling, every component's area is counted, components with area >=
``area_ratio`` x the largest survive, and the box is the extent of the
surviving pixels mirrored around the annotated point ("expand"), with a
[0, 0, 1, 1] fallback when nothing survives.
"""

from __future__ import annotations

import torch

__all__ = ["normalize_cam", "norm_attns", "bbox_from_labels_batch"]


def normalize_cam(cam: torch.Tensor) -> torch.Tensor:
    """Min-max normalise each (H, W) map of a (..., H, W) stack, with the
    span floored at 1e-6."""
    lo = cam.amin(dim=(-2, -1), keepdim=True)
    hi = cam.amax(dim=(-2, -1), keepdim=True)
    return (cam - lo) / (hi - lo).clamp_min(1e-6)


def norm_attns(attns: torch.Tensor) -> torch.Tensor:
    """Per-map min-max over the last two axes (no floor, as the reference)."""
    lo = attns.amin(dim=(-2, -1), keepdim=True)
    hi = attns.amax(dim=(-2, -1), keepdim=True)
    return (attns - lo) / (hi - lo)


def bbox_from_labels_batch(labels: torch.Tensor, points: torch.Tensor,
                           area_ratio: float = 0.5) -> torch.Tensor:
    """(K, H, W) int component labels (0 = background), (K, 2) xy points
    -> (K, 4) xyxy boxes in label-grid coordinates."""
    k, h, w = labels.shape
    n = h * w
    flat = labels.reshape(k, n).long()
    # component areas by label (labels are flat index + 1 <= n)
    areas = torch.zeros((k, n + 1), dtype=torch.long, device=labels.device)
    areas.scatter_add_(1, flat, torch.ones_like(flat))
    area_px = torch.gather(areas, 1, flat)
    fg = flat > 0
    max_area = torch.where(fg, area_px, 0).amax(dim=1, keepdim=True)
    keep = fg & (area_px >= area_ratio * max_area)

    pos = torch.arange(n, device=labels.device)
    fx = (pos % w).float()[None].expand(k, n)
    fy = (pos // w).float()[None].expand(k, n)
    big = 1e9
    xmin = torch.where(keep, fx, big).amin(dim=1)
    xmax = torch.where(keep, fx, -big).amax(dim=1)
    ymin = torch.where(keep, fy, big).amin(dim=1)
    ymax = torch.where(keep, fy, -big).amax(dim=1)
    any_keep = keep.any(dim=1)

    pts = points.float()
    xc, yc = pts[:, 0], pts[:, 1]

    def expand(lo, hi, c, limit):
        use_lo = (c - lo).abs() > (c - hi).abs()
        out_lo = torch.where(use_lo, lo, (2 * c - hi).clamp_min(0.0))
        out_hi = torch.where(use_lo, (2 * c - lo).clamp_max(limit), hi)
        return out_lo, out_hi

    bx1, bx2 = expand(xmin, xmax, xc, float(w))
    by1, by2 = expand(ymin, ymax, yc, float(h))
    box = torch.stack([bx1, by1, bx2, by2], dim=1)
    fallback = torch.tensor([0.0, 0.0, 1.0, 1.0], device=labels.device)
    return torch.where(any_keep[:, None], box, fallback[None, :])
