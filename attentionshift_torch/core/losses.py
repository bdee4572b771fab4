"""Loss functions with mmdet-compatible semantics.

Port of ``attentionshift_tpu/core/losses.py`` (the train step's losses):
sigmoid focal loss, softmax and sigmoid cross-entropy, L1, smooth L1 (the
Mask R-CNN box head's) and GIoU. All
take explicit weights and an ``avg_factor`` like mmdet, on fixed-shape
padded tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .boxes import bbox_overlaps

__all__ = ["sigmoid_focal_loss", "softmax_cross_entropy", "binary_cross_entropy", "l1_loss",
           "smooth_l1_loss", "giou_loss"]


def _reduce(loss, weight, avg_factor):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.mean()
    if not torch.is_tensor(avg_factor):
        avg_factor = loss.new_tensor(float(avg_factor))
    return loss.sum() / avg_factor.clamp_min(1e-6)


def _bce_with_logits(logits, targets):
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, labels, weight=None, gamma: float = 2.0, alpha: float = 0.25,
                       avg_factor=None):
    """mmdet FocalLoss(use_sigmoid=True); ``labels`` in [0, C], C = background."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes].to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1 - p) * onehot + p * (1 - onehot)
    focal_weight = (alpha * onehot + (1 - alpha) * (1 - onehot)) * pt**gamma
    loss = (_bce_with_logits(logits, onehot) * focal_weight).sum(-1)
    return _reduce(loss, weight, avg_factor)


def softmax_cross_entropy(logits, labels, weight=None, avg_factor=None):
    """mmdet CrossEntropyLoss(use_sigmoid=False); labels are class ids."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _reduce(nll, weight, avg_factor)


def binary_cross_entropy(logits, targets, weight=None, avg_factor=None):
    """mmdet CrossEntropyLoss(use_sigmoid=True) with {0,1} float targets."""
    loss = _bce_with_logits(logits, targets.to(logits.dtype))
    if loss.dim() > targets.dim():
        loss = loss.sum(-1)
    return _reduce(loss, weight, avg_factor)


def l1_loss(pred, target, weight=None, avg_factor=None):
    return _reduce((pred - target).abs(), weight, avg_factor)


def smooth_l1_loss(pred, target, beta: float = 1.0, weight=None, avg_factor=None):
    """mmdet SmoothL1Loss: 0.5 x^2 / beta below beta, |x| - beta / 2 above;
    elementwise when neither ``weight`` nor ``avg_factor`` is given."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    if weight is None and avg_factor is None:
        return loss
    return _reduce(loss, weight, avg_factor)


def giou_loss(pred, target, weight=None, avg_factor=None, eps: float = 1e-7):
    """1 - GIoU on aligned (N, 4) xyxy pairs (mmdet GIoULoss)."""
    giou = bbox_overlaps(pred[:, None, :], target[:, None, :], mode="giou", eps=eps)[:, 0, 0]
    return _reduce(1.0 - giou, weight, avg_factor)
