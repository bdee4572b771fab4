"""Test-time point -> box decoding (the alternative inference path).

Port of ``attentionshift_tpu/pseudo/point2bbox.py``: detections come
straight from the point tokens, with no RPN/RCNN. A token's score is
its largest sigmoid class probability and its label that class; tokens
at or above ``seed_score_thr`` are valid. Each token's rollout CAM is
resized to the ``cam_stride`` grid, min-max normalised and thresholded
at ``seed_thr``; its connected components of area >= ``seed_multiple``
x the largest are kept, and their extent is mirrored around the
token's predicted point (Stage A's "expand" rule). Fixed shape: all P
tokens are decoded, the low-score ones marked invalid.

The JAX function labels the P planes one by one (a vmapped plain CCL);
here all P planes go to one ``ops.ccl.connected_components_batch`` call,
which launches the CCL kernel on the card and runs its plain version on
the CPU. A plane that converges within ``ccl_iters`` sweeps is a
fixpoint, so both give the labels the JAX function gives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.ccl import connected_components_batch
from ..ops.image import resize
from .cam import bbox_from_labels_batch, normalize_cam

__all__ = ["point2bbox", "PointDetections"]


class PointDetections(NamedTuple):
    boxes: torch.Tensor  # (P, 4)
    scores: torch.Tensor  # (P,)
    labels: torch.Tensor  # (P,) int32
    valid: torch.Tensor  # (P,) bool


def point_planes(rollout_rows: torch.Tensor, patch_hw: tuple[int, int], seed_thr: float = 0.2,
                 cam_stride: int = 8) -> torch.Tensor:
    """(P, T) rollout rows (cls | patches | ...) -> (P, H/s, W/s) bool
    planes: each token's patch CAM resized to the ``cam_stride`` grid of
    the 16-pixel patch image, min-max normalised, thresholded."""
    p = rollout_rows.shape[0]
    hp, wp = patch_hw
    cams = rollout_rows[:, 1:1 + hp * wp].float().reshape(p, hp, wp)
    cams = resize(cams, (hp * 16 // cam_stride, wp * 16 // cam_stride))
    return normalize_cam(cams) >= seed_thr


def point2bbox(point_cls: torch.Tensor, point_reg: torch.Tensor, rollout_rows: torch.Tensor,
               patch_hw: tuple[int, int], img_wh: torch.Tensor, seed_score_thr: float = 0.05,
               seed_thr: float = 0.2, seed_multiple: float = 0.5, cam_stride: int = 8,
               ccl_iters: int = 64) -> PointDetections:
    """One image.

    Args:
        point_cls: (P, C) point-token logits; point_reg: (P, 2) in [0, 1].
        rollout_rows: (P, T) final-layer rollout rows (cls | patches | points).
        patch_hw: (Hp, Wp); img_wh: (2,) true (w, h).
    """
    probs = torch.sigmoid(point_cls.float())
    scores, labels = probs.amax(-1), probs.argmax(-1)
    img_wh = img_wh.float()
    points = point_reg.float() * img_wh[None, :]  # (P, 2) absolute xy
    planes = point_planes(rollout_rows, patch_hw, seed_thr, cam_stride)
    comp = connected_components_batch(planes, ccl_iters)
    boxes = bbox_from_labels_batch(comp, points / cam_stride, seed_multiple) * cam_stride
    zero = boxes.new_zeros(())
    wmax, hmax = img_wh[0], img_wh[1]
    boxes = torch.stack([boxes[:, 0].clamp(zero, wmax), boxes[:, 1].clamp(zero, hmax),
                         boxes[:, 2].clamp(zero, wmax), boxes[:, 3].clamp(zero, hmax)], dim=-1)
    return PointDetections(boxes=boxes, scores=scores, labels=labels.to(torch.int32),
                           valid=scores >= seed_score_thr)
