"""Anchor RPN head (stock mmdet ``RPNHead`` semantics, fixed-shape).

Port of ``attentionshift_tpu/models/rpn.py``: 3x3 conv + relu, 1x1
objectness (A anchors per location) and 1x1 box deltas, all
Normal(0.01)-initialised as mmdet's; ``rpn_loss`` with MaxIoU assignment
against the pseudo boxes and 256 random samples at pos_fraction 0.5, in
compact-index form (the loss touches only the sampled anchors);
``rpn_proposals``: per-level top-k -> decode -> clip -> level-aware NMS
0.7 -> top ``max_per_img``.

The samplers' uniforms come from ``generator`` or from ``draws``
(per image ``dict(u_pos=..., u_neg=...)``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.assign import max_iou_assign, random_sample_idx
from ..core.boxes import bbox2delta, delta2bbox
from ..core.losses import binary_cross_entropy, l1_loss
from ..ops.nms import batched_nms
from ..ops.topk import top_k_set, top_k_stable
from .layers import Conv3x3Matmul, Dense

__all__ = ["RPNHead", "rpn_loss", "rpn_proposals", "Proposals"]


class RPNHead(nn.Module):
    def __init__(self, feat_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = Conv3x3Matmul(feat_channels, feat_channels)
        self.rpn_cls = Dense(feat_channels, num_anchors)
        self.rpn_reg = Dense(feat_channels, num_anchors * 4)
        self.reset_parameters()

    def reset_parameters(self):
        with torch.no_grad():
            for conv in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
                conv.weight.normal_(0.0, 0.01)
                conv.bias.zero_()

    def forward(self, feats):
        """feats: per-level (B, H, W, C) -> per-level lists of
        cls (B, H, W, A) and reg (B, H, W, A*4)."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            y = F.relu(self.rpn_conv(x))
            cls_scores.append(self.rpn_cls(y))
            bbox_preds.append(self.rpn_reg(y))
        return cls_scores, bbox_preds


def _flatten_levels(cls_scores, bbox_preds):
    b = cls_scores[0].shape[0]
    return (torch.cat([c.reshape(b, -1) for c in cls_scores], dim=1),
            torch.cat([r.reshape(b, -1, 4) for r in bbox_preds], dim=1))


def rpn_loss(cls_scores, bbox_preds, anchors, gt_boxes, gt_valid, num_samples: int = 256,
             pos_fraction: float = 0.5, pos_iou_thr: float = 0.7, neg_iou_thr: float = 0.3,
             min_pos_iou: float = 0.3, generator=None, draws=None):
    """Per-image-batched RPN loss; ``gt_boxes`` (B, G, 4) padded."""
    cls_flat, reg_flat = _flatten_levels(cls_scores, bbox_preds)
    lcs, lrs = [], []
    for i in range(cls_flat.shape[0]):
        gts = gt_boxes[i].float()
        assign = max_iou_assign(anchors, gts, torch.zeros_like(gt_valid[i], dtype=torch.int32),
                                gt_valid[i], pos_iou_thr, neg_iou_thr, min_pos_iou,
                                match_low_quality=True)
        dr = draws[i] if draws is not None else {}
        s = random_sample_idx(assign.assigned_gt, num_samples, pos_fraction,
                              u_pos=dr.get("u_pos"), u_neg=dr.get("u_neg"))
        idx = torch.cat([s.pos_idx, s.neg_idx]).long()
        vmask = torch.cat([s.pos_valid, s.neg_valid]).float()
        targets_cls = torch.cat([torch.ones_like(s.pos_valid), torch.zeros_like(s.neg_valid)]).float()
        avg = vmask.sum().clamp_min(1.0)
        lcs.append(binary_cross_entropy(cls_flat[i][idx].float(), targets_cls, weight=vmask,
                                        avg_factor=avg))
        pos = s.pos_idx.long()
        gt_idx = (assign.assigned_gt[pos] - 1).clamp(0, gts.shape[0] - 1).long()
        tgt_deltas = bbox2delta(anchors[pos], gts[gt_idx])
        lrs.append(l1_loss(reg_flat[i][pos].float(), tgt_deltas,
                           weight=s.pos_valid.float()[:, None], avg_factor=avg))
    return {"loss_rpn_cls": torch.stack(lcs).mean(), "loss_rpn_bbox": torch.stack(lrs).mean()}


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (B, K, 4)
    scores: torch.Tensor  # (B, K)
    valid: torch.Tensor  # (B, K) bool


def rpn_proposals(cls_scores, bbox_preds, anchors_per_level, img_shape, nms_pre: int = 2000,
                  max_per_img: int = 1000, iou_threshold: float = 0.7,
                  min_bbox_size: float = 0.0) -> Proposals:
    """Decode + level-aware NMS (mmdet RPNHead._get_bboxes_single).

    The selections (top-k, NMS) build no graph, but the kept boxes stay
    differentiable in the box deltas, as in the JAX package, whose RCNN
    losses reach the RPN through the proposals' coordinates.
    """
    b = cls_scores[0].shape[0]
    out = []
    for i in range(b):
        sel_scores, sel_boxes, sel_lvls = [], [], []
        for lvl, (c, r, anc) in enumerate(zip(cls_scores, bbox_preds, anchors_per_level)):
            scores = torch.sigmoid(c[i].reshape(-1).float())
            deltas = r[i].reshape(-1, 4).float()
            n = scores.shape[0]
            k = min(nms_pre, n)
            # large levels: the exact SET in index order; small ones in rank
            # order, as the JAX package chooses between its two selections
            with torch.no_grad():
                top_i = (top_k_set(scores, k) if n >= 8 * k else top_k_stable(scores, k))[1].long()
            sel_scores.append(scores[top_i])
            sel_boxes.append(delta2bbox(anc[top_i], deltas[top_i], max_shape=img_shape))
            sel_lvls.append(torch.full((k,), lvl, dtype=torch.int32, device=scores.device))
        sc, bx, lv = torch.cat(sel_scores), torch.cat(sel_boxes), torch.cat(sel_lvls)
        with torch.no_grad():
            ok = (bx[:, 2] - bx[:, 0] > min_bbox_size) & (bx[:, 3] - bx[:, 1] > min_bbox_size)
            keep_idx, keep_valid = batched_nms(bx, torch.where(ok, sc, -1.0), lv, iou_threshold,
                                               max_per_img, valid=ok & (sc > -1.0))
        keep = keep_idx.long()
        out.append((bx[keep], torch.where(keep_valid, sc[keep], 0.0), keep_valid))
    return Proposals(*(torch.stack(t) for t in zip(*out)))
