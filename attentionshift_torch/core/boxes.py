"""Box toolbox: overlaps, delta coding, clipping.

Port of ``attentionshift_tpu/core/boxes.py`` (the train step's part):
``bbox_overlaps``, ``DeltaXYWHBBoxCoder`` as ``bbox2delta``/``delta2bbox``
and ``clip_boxes``. Pure functions on xyxy boxes with any leading axes.
"""

from __future__ import annotations

import math

import torch

__all__ = ["bbox_overlaps", "delta2bbox", "bbox2delta", "clip_boxes"]


def bbox_overlaps(a: torch.Tensor, b: torch.Tensor, mode: str = "iou",
                  eps: float = 1e-6) -> torch.Tensor:
    """Pairwise overlaps (..., N, 4) x (..., M, 4) -> (..., N, M); mode
    'iou' | 'iof' | 'giou'."""
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    if mode == "iof":
        return inter / area_a[..., :, None].clamp_min(eps)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / union.clamp_min(eps)
    if mode == "iou":
        return iou
    if mode == "giou":
        lt_c = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
        rb_c = torch.maximum(a[..., :, None, 2:4], b[..., None, :, 2:4])
        wh_c = (rb_c - lt_c).clamp_min(0.0)
        area_c = (wh_c[..., 0] * wh_c[..., 1]).clamp_min(eps)
        return iou - (area_c - union) / area_c
    raise ValueError(f"unknown mode {mode}")


def bbox2delta(proposals, gt, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0)):
    """Encode gt boxes as deltas wrt proposals (DeltaXYWHBBoxCoder.encode)."""
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    dx = (gx - px) / pw.clamp_min(1e-6)
    dy = (gy - py) / ph.clamp_min(1e-6)
    dw = torch.log(gw.clamp_min(1e-6) / pw.clamp_min(1e-6))
    dh = torch.log(gh.clamp_min(1e-6) / ph.clamp_min(1e-6))
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def delta2bbox(rois, deltas, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
               max_shape=None, wh_ratio_clip: float = 16 / 1000):
    """Decode deltas into boxes (DeltaXYWHBBoxCoder.decode)."""
    d = deltas * deltas.new_tensor(stds) + deltas.new_tensor(means)
    dx, dy, dw, dh = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    boxes = torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes


def clip_boxes(boxes, max_shape):
    """Clamp xyxy boxes to [0, W] x [0, H]; max_shape = (H, W)."""
    h, w = max_shape[0], max_shape[1]
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)
