"""Hungarian point assignment of point tokens to annotated points.

Port of ``hungarian_point_assign`` (``attentionshift_tpu/core/assign.py:
171-232``): cost = sigmoid-focal class cost + 10 x L1 between the
predicted point and the normalised annotation, invalid annotations at a
1e9 cost, one assignment per round with matched tokens masked.
"""

from __future__ import annotations

import torch

from .lsa import linear_sum_assignment

__all__ = ["hungarian_point_assign"]


def _focal_cls_cost(cls_pred, gt_labels, alpha=0.25, gamma=2.0, eps=1e-12):
    """mmdet FocalLossCost: (P, C) logits, (G,) labels -> (P, G)."""
    p = torch.sigmoid(cls_pred)
    neg_cost = -torch.log(1.0 - p + eps) * (1.0 - alpha) * p**gamma
    pos_cost = -torch.log(p + eps) * alpha * (1.0 - p) ** gamma
    return (pos_cost - neg_cost)[:, gt_labels.long()]


def hungarian_point_assign(cls_pred, pt_pred, gt_points, gt_labels, gt_valid, img_wh,
                           cls_weight: float = 1.0, reg_weight: float = 10.0,
                           times: int = 1) -> torch.Tensor:
    """(P,) int32 assigned gt per token: 0 = none, i + 1 = annotation i.

    Args:
        cls_pred: (P, C) point-token class logits; pt_pred: (P, 2) sigmoid xy.
        gt_points: (G, 2) absolute xy; gt_labels: (G,); gt_valid: (G,) bool;
        img_wh: (2,) = (W, H).
    """
    cls_pred, pt_pred = cls_pred.detach().float(), pt_pred.detach().float()
    p = pt_pred.shape[0]
    g = gt_points.shape[0]
    gt_norm = gt_points.float() / img_wh.float()[None, :]
    cost_reg = (pt_pred[:, None, :] - gt_norm[None, :, :]).abs().sum(-1)
    cost = cls_weight * _focal_cls_cost(cls_pred, gt_labels) + reg_weight * cost_reg
    big = 1e9
    cost = torch.where(gt_valid[None, :].bool(), cost, big)
    assigned = torch.zeros(p, dtype=torch.int32, device=cls_pred.device)
    rows = torch.arange(g, device=cls_pred.device)
    for _ in range(times):
        masked = torch.where((assigned > 0)[:, None], big, cost)
        col = linear_sum_assignment(masked.T, row_valid=gt_valid)
        ok = gt_valid.bool() & (col >= 0) & (masked.T[rows, col.long().clamp_min(0)] < big / 2)
        upd = torch.zeros(p + 1, dtype=torch.int32, device=cls_pred.device)
        upd[torch.where(ok, col.long(), p)] = torch.where(ok, rows.int() + 1, 0).int()
        upd = upd[:p]
        assigned = torch.where((assigned == 0) & (upd > 0), upd, assigned)
    return assigned
