"""Geometric and contrastive losses: the chamfer family, the border loss, InfoNCE.

Port of ``attentionshift_tpu/core/losses_geom.py``, which the RepPoints
part-refinement head consumes. Ragged point sets are padded tensors with
validity masks; invalid points are left out of both nearest-neighbour
minima and of the means.

Each normaliser that counts objects goes through
``parallel.mesh.global_count``, so that under a data-parallel train step
the loss is the one over the global batch, as XLA makes it in the JAX
package.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import global_count

__all__ = ["chamfer_distance", "chamfer_loss", "sim_masked_chamfer_loss", "pts_border_loss",
           "info_nce_loss"]

_BIG = 1e9


def chamfer_distance(x, y, x_valid=None, y_valid=None):
    """Symmetric chamfer distance: L2 point distances, the mean of the
    nearest-neighbour distances each way, averaged.

    x (..., P1, 2), y (..., P2, 2); x_valid / y_valid optional (..., P1) /
    (..., P2) masks.
    """
    c = torch.linalg.vector_norm(x[..., :, None, :] - y[..., None, :, :], dim=-1)
    if y_valid is not None:
        c = torch.where(y_valid[..., None, :], c, _BIG)
    if x_valid is not None:
        c = torch.where(x_valid[..., :, None], c, _BIG)

    def masked_mean(vals, valid):
        if valid is None:
            return vals.mean(-1)
        vals = torch.where(valid, vals, 0.0)
        return vals.sum(-1) / valid.sum(-1).clamp_min(1)

    d1 = masked_mean(c.amin(-1), x_valid)  # x -> nearest y
    d2 = masked_mean(c.amin(-2), y_valid)  # y -> nearest x
    return (d1 + d2) / 2.0


def chamfer_loss(pts_pred, pts_gt, pred_valid=None, gt_valid=None, obj_valid=None,
                 loss_weight: float = 1.0):
    """``ChamferLoss2D``: the chamfer distance per object (N, P1, 2) against
    (N, P2, 2), averaged over the valid objects ``obj_valid`` (N,)."""
    d = chamfer_distance(pts_pred, pts_gt, pred_valid, gt_valid)  # (N,)
    if obj_valid is not None:
        d = torch.where(obj_valid, d, 0.0)
        return loss_weight * d.sum() / global_count(obj_valid.sum().float())
    return loss_weight * d.mean()


def sim_masked_chamfer_loss(part_pts, contour_pts, part_feats, contour_feats, part_valid,
                            contour_valid, obj_valid, sim_thr: float = 0.85,
                            loss_weight: float = 1.0):
    """``SimFocusChamferLoss2D``: per part, the chamfer distance against the
    contour points whose features are cosine-similar (>= ``sim_thr``) to
    the part's.

    part_pts (N, K, Pp, 2), contour_pts (N, Pc, 2), part_feats (N, K, D),
    contour_feats (N, Pc, D), part_valid (N, K), contour_valid (N, Pc),
    obj_valid (N,).
    """
    fp = part_feats / torch.linalg.vector_norm(part_feats, dim=-1, keepdim=True).clamp_min(1e-6)
    fc = contour_feats / torch.linalg.vector_norm(contour_feats, dim=-1,
                                                  keepdim=True).clamp_min(1e-6)
    sim = torch.einsum("nkd,npd->nkp", fp, fc)  # (N, K, Pc)
    sim_ok = (sim >= sim_thr) & contour_valid[:, None, :]
    has_any = sim_ok.any(-1)  # parts without a similar contour point give 0
    d = chamfer_distance(part_pts, contour_pts[:, None].expand(*sim.shape[:2], *contour_pts.shape[1:]),
                         x_valid=part_valid[..., None].expand(part_pts.shape[:-1]), y_valid=sim_ok)
    d = torch.where(part_valid & has_any, d, 0.0)
    per_obj = d.sum(-1) / part_valid.sum(-1).clamp_min(1)
    per_obj = torch.where(obj_valid, per_obj, 0.0)
    return loss_weight * per_obj.sum() / global_count(obj_valid.sum().float())


def pts_border_loss(pts, gt_bboxes, valid=None, loss_weight: float = 1.0, y_first: bool = False):
    """``PtsBorderLoss``: hinge penalty of the points outside their gt box.

    pts (N, P*2) or (N, P, 2), gt_bboxes (N, 4), valid (N,) objects: the
    mean over the points per side, summed over the four sides, averaged
    over 4 x the valid objects.
    """
    p = pts.reshape(pts.shape[0], -1, 2)
    px = p[:, :, 1] if y_first else p[:, :, 0]
    py = p[:, :, 0] if y_first else p[:, :, 1]
    left = (gt_bboxes[:, None, 0] - px).clamp_min(0)
    right = (px - gt_bboxes[:, None, 2]).clamp_min(0)
    up = (gt_bboxes[:, None, 1] - py).clamp_min(0)
    bottom = (py - gt_bboxes[:, None, 3]).clamp_min(0)
    per_obj = torch.stack([left, right, up, bottom], dim=1).mean(-1).sum(-1)  # (N,)
    if valid is not None:
        per_obj = torch.where(valid, per_obj, 0.0)
        return loss_weight * per_obj.sum() / global_count(valid.sum().float() * 4.0)
    return loss_weight * per_obj.mean() / 4.0


def info_nce_loss(query, positive_key, negative_keys=None, temperature: float = 0.1,
                  paired: bool = False):
    """InfoNCE: L2-normalised dot-product logits over ``temperature``,
    cross-entropy against the positive.

    query, positive_key (N, D); negative_keys (M, D) unpaired or (N, M, D)
    paired; None: the other positives are the negatives.
    """
    def norm(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)

    q, pk = norm(query), norm(positive_key)
    if negative_keys is None:
        logp = torch.log_softmax(q @ pk.T / temperature, dim=-1)  # diagonal = positives
        return -torch.diagonal(logp).mean()
    nk = norm(negative_keys)
    pos = (q * pk).sum(-1, keepdim=True)  # (N, 1)
    neg = torch.einsum("nd,nmd->nm", q, nk) if paired else q @ nk.T
    logp = torch.log_softmax(torch.cat([pos, neg], dim=-1) / temperature, dim=-1)
    return -logp[:, 0].mean()
