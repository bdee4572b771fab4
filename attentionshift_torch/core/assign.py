"""Assigners and samplers, fixed-shape (padded gt with validity masks).

Port of ``attentionshift_tpu/core/assign.py``:

- ``max_iou_assign``: mmdet ``MaxIoUAssigner`` (-1 ignore, 0 negative,
  i + 1 positive for gt i);
- ``random_sample`` / ``random_sample_idx``: mmdet ``RandomSampler`` as
  top-k by an i.i.d. uniform score (ties by lowest index). The uniforms
  come from a ``torch.Generator`` or are handed in (``u_pos``, ``u_neg``),
  so a test can replay another package's draws;
- ``hungarian_point_assign``: cost = sigmoid-focal class cost + 10 x L1
  between the predicted point and the normalised annotation, invalid
  annotations at a 1e9 cost, one assignment per round with matched
  tokens masked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.topk import top_k_stable
from .boxes import bbox_overlaps
from .lsa import linear_sum_assignment

__all__ = ["max_iou_assign", "random_sample", "random_sample_idx", "hungarian_point_assign",
           "AssignResult", "SampleResult", "SampleIdxResult"]


class AssignResult(NamedTuple):
    assigned_gt: torch.Tensor  # (N,) int32: -1 ignore / 0 neg / i+1 pos
    max_iou: torch.Tensor  # (N,) float32
    labels: torch.Tensor  # (N,) int32 assigned class (-1 if none)


@torch.no_grad()
def max_iou_assign(boxes, gt_boxes, gt_labels, gt_valid, pos_iou_thr: float, neg_iou_thr: float,
                   min_pos_iou: float = 0.0, match_low_quality: bool = True) -> AssignResult:
    """mmdet MaxIoUAssigner.assign with padded gts: boxes (N, 4), gt_boxes
    (G, 4), gt_labels (G,), gt_valid (G,)."""
    g = gt_boxes.shape[0]
    gt_valid = gt_valid.bool()
    ious = bbox_overlaps(gt_boxes, boxes)  # (G, N)
    ious = torch.where(gt_valid[:, None], ious, -1.0)
    max_iou, argmax = ious.max(dim=0)
    assigned = torch.full_like(argmax, -1, dtype=torch.int32)
    assigned = torch.where((max_iou >= 0) & (max_iou < neg_iou_thr), 0, assigned)
    assigned = torch.where(max_iou >= pos_iou_thr, argmax.int() + 1, assigned)
    if match_low_quality:
        # each gt claims its best-overlapping box(es) if >= min_pos_iou; gts
        # go in order, so the LAST claiming gt wins a box
        gt_max = ious.max(dim=1).values
        claim = (ious == gt_max[:, None]) & (gt_max >= min_pos_iou)[:, None] & gt_valid[:, None]
        ids = torch.arange(1, g + 1, device=boxes.device, dtype=torch.int32)
        last = torch.where(claim, ids[:, None], 0).max(dim=0).values
        assigned = torch.where(last > 0, last, assigned)
    lbl = torch.where(assigned > 0, gt_labels.int()[(assigned - 1).clamp(0, g - 1).long()], -1)
    return AssignResult(assigned.int(), max_iou, lbl.int())


class SampleResult(NamedTuple):
    pos_mask: torch.Tensor  # (N,) bool: sampled positives
    neg_mask: torch.Tensor  # (N,) bool: sampled negatives


class SampleIdxResult(NamedTuple):
    pos_idx: torch.Tensor  # (P,) int32 sampled positive indices
    pos_valid: torch.Tensor  # (P,) bool slot validity
    neg_idx: torch.Tensor  # (Q,) int32 sampled negative indices
    neg_valid: torch.Tensor  # (Q,) bool


def _uniform(u, n, device, generator):
    if u is not None:
        return u.to(device=device, dtype=torch.float32)
    return torch.rand(n, device=device, generator=generator)


@torch.no_grad()
def random_sample_idx(assigned_gt, num: int, pos_fraction: float, u_pos=None, u_neg=None,
                      generator=None) -> SampleIdxResult:
    """``random_sample`` in compact-index form: the same selection law, but
    the result is the fixed-size LIST of sampled indices (with slot
    validity) instead of (N,) masks."""
    n = assigned_gt.shape[0]
    dev = assigned_gt.device
    pos_cap = int(num * pos_fraction)

    def pick(u, mask, cap_static, cap_dynamic):
        score = torch.where(mask, u, -1.0)
        top_s, idx = top_k_stable(score, cap_static)
        valid = (torch.arange(cap_static, device=dev) < cap_dynamic) & (top_s > -1.0)
        return idx.int(), valid

    pos_idx, pos_valid = pick(_uniform(u_pos, n, dev, generator), assigned_gt > 0,
                              min(pos_cap, n), pos_cap)
    neg_cap = num - pos_valid.sum().clamp_max(pos_cap)
    neg_idx, neg_valid = pick(_uniform(u_neg, n, dev, generator), assigned_gt == 0,
                              min(num, n), neg_cap)
    return SampleIdxResult(pos_idx, pos_valid, neg_idx, neg_valid)


@torch.no_grad()
def random_sample(assigned_gt, num: int, pos_fraction: float, u_pos=None, u_neg=None,
                  generator=None) -> SampleResult:
    """mmdet RandomSampler: up to num*pos_fraction random positives, the
    remainder random negatives; returns boolean masks."""
    n = assigned_gt.shape[0]
    dev = assigned_gt.device
    pos_cap = int(num * pos_fraction)

    def pick(u, mask, cap_static, cap_dynamic):
        score = torch.where(mask, u, -1.0)
        _, idx = top_k_stable(score, cap_static)
        keep = torch.arange(cap_static, device=dev) < cap_dynamic
        sel = torch.zeros(n, dtype=torch.bool, device=dev)
        sel[idx] = keep
        return sel & mask

    pos_sel = pick(_uniform(u_pos, n, dev, generator), assigned_gt > 0, min(pos_cap, n), pos_cap)
    neg_cap = num - pos_sel.sum().clamp_max(pos_cap)
    neg_sel = pick(_uniform(u_neg, n, dev, generator), assigned_gt == 0, min(num, n), neg_cap)
    return SampleResult(pos_sel, neg_sel)


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
