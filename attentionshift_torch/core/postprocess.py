"""Detection post-processing: multiclass NMS (fixed-shape).

Port of ``attentionshift_tpu/core/postprocess.py``: mmdet's
``multiclass_nms`` with static shapes. A score-threshold mask and a
global top-k pre-selection take the place of dynamic filtering, then
class-aware greedy NMS runs over the fixed candidate set.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.nms import batched_nms
from ..ops.topk import top_k_stable

__all__ = ["multiclass_nms", "Detections"]


class Detections(NamedTuple):
    boxes: torch.Tensor  # (K, 4)
    scores: torch.Tensor  # (K,)
    labels: torch.Tensor  # (K,) int32
    valid: torch.Tensor  # (K,) bool


def multiclass_nms(boxes, scores, score_thr: float, iou_threshold: float, max_per_img: int,
                   pre_nms_top_n: int = 1000, box_valid=None) -> Detections:
    """Args:
        boxes: (N, C*4) class-specific or (N, 4) agnostic xyxy.
        scores: (N, C+1) softmax probabilities, last column = background.
        score_thr: per-candidate score floor (0.05 in the VOC config).
        pre_nms_top_n: static candidate cap before the O(K^2) NMS.
        box_valid: optional (N,) validity of the input rows.

    Returns fixed-size ``Detections`` with ``max_per_img`` slots. Every
    rejected candidate scores -1.0, so the pre-selection is full of ties:
    it is a stable descending sort (lowest index first), as ``lax.top_k``
    ranks them. The selections build no graph; the kept boxes and scores
    stay differentiable in the inputs.
    """
    n, num_cls_p1 = scores.shape
    c = num_cls_p1 - 1
    cls_scores = scores[:, :c]  # drop background
    if boxes.shape[-1] == 4:
        cand_boxes = boxes[:, None, :].expand(n, c, 4)
    else:
        cand_boxes = boxes.reshape(n, c, 4)
    cand_boxes = cand_boxes.reshape(n * c, 4)
    cand_scores = cls_scores.reshape(n * c)
    cand_labels = torch.arange(c, dtype=torch.int32, device=scores.device).repeat(n)
    ok = cand_scores > score_thr
    if box_valid is not None:
        ok &= box_valid.bool().repeat_interleave(c)

    k = min(pre_nms_top_n, n * c)
    masked_scores = torch.where(ok, cand_scores, -1.0)
    with torch.no_grad():
        top_idx = top_k_stable(masked_scores, k)[1]
        top_labels = cand_labels[top_idx]
        keep_idx, keep_valid = batched_nms(cand_boxes[top_idx], masked_scores[top_idx], top_labels,
                                           iou_threshold, max_per_img,
                                           valid=masked_scores[top_idx] > 0.0)
        keep = top_idx[keep_idx.long()]
    return Detections(
        boxes=cand_boxes[keep],
        scores=torch.where(keep_valid, masked_scores[keep], 0.0),
        labels=cand_labels[keep],
        valid=keep_valid,
    )
