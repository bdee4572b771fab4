"""RepPoints-style dense part refinement head (the COCO configs' cascade).

Port of ``attentionshift_tpu/models/reppoints.py``:

- ``contour_points``: fixed-size point sets drawn without replacement from
  each mask's contour (the mask minus its 3x3 erosion);
- ``RepPointsPartHead``: three 3x3 conv + GroupNorm(32) + ReLU layers
  over the stride-16 features, a sigmoid objectness map (``cls_out``) and
  a dense field of ``num_points`` offsets per location (``pts_out``),
  point-sampled at each semantic center. Losses: the border loss of each
  object's points against its box, the chamfer distances of its points
  to its semantic centers and to its mask contour, and the objectness BCE
  against the fg occupancy. The refined centers are the mean of each
  part's points inside its box;
- ``refine_fg_maps``: the fg maps re-estimated from the refined centers
  between cascade stages (``update_fg_map``).

Shapes are fixed: G objects x P parts with validity masks. The random
draws (the contour points, the background supplement of
``refine_fg_maps``) come from a ``torch.Generator`` or are handed in as
Gumbel noise, so that tests can replay the JAX package's. Every count a
loss divides by goes through ``parallel.mesh.global_count``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.losses import binary_cross_entropy
from ..core.losses_geom import chamfer_loss, pts_border_loss
from ..ops.image import resize
from ..ops.masks import corrosion
from ..ops.sampling import point_sample
from ..parallel.mesh import global_count
from ..pseudo.points import topk_in_mask
from ..pseudo.refine import _cos_map, refined_similarity_from_map
from .layers import Conv3x3Matmul, Dense

__all__ = ["RepPointsPartHead", "contour_points", "refine_fg_maps"]


class RepPointsOut(NamedTuple):
    losses: dict
    new_centers: torch.Tensor  # (B, G, P, 2), no graph
    new_valid: torch.Tensor  # (B, G, P)


def contour_points(masks: torch.Tensor, num_points: int, generator=None, gumbel=None):
    """(G, H, W) binary masks -> contour points (G, Pc, 2) xy float and
    their validity (G, Pc). ``gumbel``: optional (G, H*W) noise of the
    draw, in place of the generator's."""
    m = masks.float()
    edge = (m - corrosion(m, 3) > 0.5) & (m > 0.5)
    coords, valid, n = topk_in_mask(edge, num_points, generator, gumbel)
    return coords.flip(-1).float(), valid & (n > 0)[:, None]


class GroupNorm(nn.Module):
    """Channel-last group norm with flax ``nn.GroupNorm``'s semantics:
    f32 statistics over (H, W, C / groups), the variance as
    E[x^2] - E[x]^2 clipped at 0, epsilon 1e-6 (torch's default is 1e-5);
    the output keeps the input's dtype."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, h, w, c = x.shape
        xg = x.float().reshape(b, h * w, self.num_groups, c // self.num_groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, h, w, c)
        return (y * self.weight + self.bias).to(x.dtype)


class RepPointsPartHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_points: int = 9, feat_channels: int = 256,
                 stacked_convs: int = 3, stride: int = 16, border_weight: float = 0.5,
                 chamfer_sem_weight: float = 1.0, chamfer_contour_weight: float = 1.0,
                 cls_weight: float = 1.0):
        super().__init__()
        self.num_points, self.stride, self.stacked_convs = num_points, stride, stacked_convs
        self.border_weight, self.cls_weight = border_weight, cls_weight
        self.chamfer_sem_weight, self.chamfer_contour_weight = chamfer_sem_weight, chamfer_contour_weight
        for i in range(stacked_convs):
            setattr(self, f"conv_{i}", Conv3x3Matmul(in_channels if i == 0 else feat_channels,
                                                     feat_channels))
            setattr(self, f"gn_{i}", GroupNorm(feat_channels))
        self.cls_out = Dense(feat_channels, 1)
        self.pts_out = Dense(feat_channels, 2 * num_points)

    def forward(self, feats, gt_boxes, centers, center_valid, gt_valid, gt_masks, fg_maps,
                contour_xy, contour_valid) -> RepPointsOut:
        """feats (B, Hf, Wf, C) stride-16 features (detached upstream);
        gt_boxes (B, G, 4); centers (B, G, P, 2) xy; center_valid (B, G, P);
        gt_valid (B, G); gt_masks (B, G, H, W) pseudo masks (supervision
        only, not read); fg_maps (B, G, H, W); contour_xy (B, G, Pc, 2) and
        contour_valid (B, G, Pc)."""
        b, hf, wf, _ = feats.shape
        g, p = centers.shape[1:3]
        k = self.num_points
        x = feats
        for i in range(self.stacked_convs):
            x = F.relu(getattr(self, f"gn_{i}")(getattr(self, f"conv_{i}")(x)))
        cls_logits = self.cls_out(x)[..., 0].float()
        pts_field = self.pts_out(x).float()

        # per-anchor offsets point-sampled from the dense field
        img_wh = centers.new_tensor([wf * self.stride, hf * self.stride])
        sampled = point_sample(pts_field.permute(0, 3, 1, 2), centers.reshape(b, g * p, 2) / img_wh)
        offsets = sampled.transpose(1, 2).reshape(b, g, p, k, 2) * self.stride
        pred_pts = centers[:, :, :, None, :] + offsets  # (B, G, P, K, 2)
        pv = center_valid & gt_valid[:, :, None]  # (B, G, P)

        # (1) border loss of each object's points; invalid points collapse
        # to the box centre
        obj_pts = pred_pts.reshape(b * g, p * k, 2)
        obj_pv = pv[..., None].expand(b, g, p, k).reshape(b * g, p * k)
        ctr = ((gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2).reshape(b * g, 1, 2)
        safe_pts = torch.where(obj_pv[..., None], obj_pts, ctr)
        obj_valid = gt_valid.reshape(-1)
        loss_border = pts_border_loss(safe_pts.reshape(b * g, -1), gt_boxes.reshape(b * g, 4),
                                      valid=obj_valid, loss_weight=self.border_weight)
        # (2) chamfer: the object's points against its semantic centers
        pv_obj = pv.reshape(b * g, p)
        loss_sem = chamfer_loss(safe_pts, centers.reshape(b * g, p, 2), pred_valid=obj_pv,
                                gt_valid=pv_obj, obj_valid=obj_valid & pv_obj.any(-1),
                                loss_weight=self.chamfer_sem_weight)
        # (3) chamfer: the object's points against its mask contour
        cval = contour_valid.reshape(b * g, -1)
        safe_cont = torch.where(cval[..., None], contour_xy.reshape(b * g, -1, 2), ctr)
        loss_contour = chamfer_loss(safe_pts, safe_cont, pred_valid=obj_pv, gt_valid=cval,
                                    obj_valid=obj_valid & cval.any(-1),
                                    loss_weight=self.chamfer_contour_weight)
        # (4) objectness: the fg occupancy at feature resolution
        occ = resize(fg_maps.amax(dim=1).float(), (hf, wf))  # (B, Hf, Wf)
        tgt = (occ > 0.5).float()
        loss_cls = self.cls_weight * binary_cross_entropy(
            cls_logits.reshape(-1), tgt.reshape(-1),
            avg_factor=global_count(torch.tensor(float(tgt.numel()), device=tgt.device)))

        # refined centers: the mean of each part's points inside its box
        with torch.no_grad():
            x1y1 = gt_boxes[:, :, None, None, :2]
            x2y2 = gt_boxes[:, :, None, None, 2:]
            inside = ((pred_pts >= x1y1) & (pred_pts <= x2y2)).all(-1)  # (B, G, P, K)
            wsum = inside.sum(-1, keepdim=True).clamp_min(1)
            new_centers = (pred_pts * inside[..., None]).sum(-2) / wsum
            any_inside = inside.any(-1)
            new_centers = torch.where(any_inside[..., None], new_centers, centers)
        losses = {"loss_rp_border": loss_border, "loss_rp_chamfer_sem": loss_sem,
                  "loss_rp_chamfer_contour": loss_contour, "loss_rp_cls": loss_cls}
        return RepPointsOut(losses, new_centers, pv & any_inside)


def refine_fg_maps(fg_maps, vit_feat, boxes, centers, center_valid, fg_proto, bg_proto, valid,
                   generator=None, pos_mask_thr: float = 0.35, bg_points_override=None,
                   gumbel=None):
    """Re-estimate one image's fg maps between cascade stages
    (``update_fg_map``).

    Per instance, the Stage-B fg prototype is mixed 0.5/0.5 with the
    scalar mean of the refined part centers' features (the reference's
    all-dims ``torch.mean``, kept). Rows G and G + 1 are the Stage-B
    bg-support prototype and a background supplement: the mean feature at
    up to 5 background pixels drawn without replacement, whose
    (row, col) / (H, W) is sampled as (x, y), as the reference does. Three
    box-masked winner-take-all refinements of the prototypes' cosine maps
    follow; the result is upsampled, suppressed by the Stage-B bg
    prototypes' cosine maps and max-normalised. Instances whose new map
    sums to 0, and padding rows, keep their old map.

    Args:
        fg_maps: (G, H, W) current full-res fg maps.
        vit_feat: (D, Hp, Wp) patch features.
        boxes: (G, 4) pseudo boxes; centers (G, P, 2) xy and center_valid
            (G, P) the refined part centers.
        fg_proto: (G + 1, D) and bg_proto (G, D) Stage-B prototypes.
        valid: (G,) instance validity.
        generator / gumbel: the background draw, or its (H*W,) noise;
        bg_points_override: (K, 2) normalised sample coords in place of it.

    Returns (new fg maps (G, H, W), pseudo masks (G, H, W) uint8).
    """
    d, hp, wp = vit_feat.shape
    g, p, _ = centers.shape
    h, w = fg_maps.shape[-2:]
    feat = vit_feat[None].float()
    # (1) the part centers' features, bilinear at centers / (W, H)
    norm_xy = centers.reshape(-1, 2) / centers.new_tensor([w, h])
    sc_feat = point_sample(feat, norm_xy[None])[0].reshape(d, g, p)
    nv = center_valid.sum(-1)  # (G,)
    scal = (sc_feat * center_valid[None]).sum(dim=(0, 2)) / (nv * d).clamp_min(1)
    mixed = torch.where((nv > 0)[:, None], 0.5 * scal[:, None] + 0.5 * fg_proto[:g], fg_proto[:g])
    # (2) the background supplement
    if bg_points_override is not None:
        bg_xy = bg_points_override.to(feat.device).float()
    else:
        bg_map = fg_maps.sum(0) == 0
        coords, _, n = topk_in_mask(bg_map[None], 5, generator,
                                    None if gumbel is None else gumbel.reshape(1, -1))
        coords = torch.where(n[0] > 0, coords[0], torch.ones_like(coords[0]))
        bg_xy = (coords.float() + 0.5) / feat.new_tensor([h, w])
    bg_supp = point_sample(feat, bg_xy[None])[0].mean(-1)  # (D,)

    protos = torch.cat([mixed, fg_proto[g:g + 1], bg_supp[None]], dim=0)  # (G + 2, D)
    valid_rows = torch.cat([valid.bool(), valid.new_ones(2, dtype=torch.bool)])
    sel, _ = refined_similarity_from_map(_cos_map(feat[0], protos), feat[0], boxes, g,
                                         refine_times=3, tau=0.85, is_select=True,
                                         valid=valid_rows)
    attn = resize(sel[:g], (h, w))
    attn = (1.0 - resize(_cos_map(feat[0], bg_proto), (h, w))) * attn
    attn = attn / attn.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-8)
    empty = (attn.sum(dim=(-2, -1)) == 0) | ~valid.bool()
    new = torch.where(empty[:, None, None], fg_maps, attn)
    mx = new.amax(dim=(-2, -1), keepdim=True)
    return new, (new > mx * pos_mask_thr).to(torch.uint8)
