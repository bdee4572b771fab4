"""Per-image pseudo-label engine: glue for Stages A-C.

Port of ``attentionshift_tpu/pseudo/engine.py``:

- ``candidate_boxes``   matched point tokens -> per-layer CAMs ->
  thresholded maps -> one batched connected-component labelling of all
  (layer, instance) planes -> per-(instance, layer) candidate boxes;
- ``masks_and_centers`` Stages B+C after the MIL choice: refined fg/bg
  maps, pseudo masks, mask supervision points and semantic centers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.ccl import connected_components_batch
from ..ops.image import resize
from .cam import bbox_from_labels_batch, normalize_cam
from .meanshift import SemanticCenters, semantic_centers
from .refine import cosine_similarity_refined_map, sample_mask_points

__all__ = ["candidate_boxes", "masks_and_centers", "PseudoLabels"]


def candidate_boxes(rollout_rows, assigned_token, gt_points, patch_hw, img_hw, seed_thr=0.2,
                    seed_multiple=0.5, cam_stride=8, ccl_iters=64, valid=None):
    """Stage A candidates for one image.

    Args:
        rollout_rows: (L, P, T) rollout point-token rows.
        assigned_token: (G,) point token matched to each annotation.
        gt_points: (G, 2) annotated xy (image coords).
        valid: optional (G,) validity; padded instances' maps are emptied
            so their labelling converges in one sweep.

    Returns:
        (G, L, 4) candidate boxes (image coords), (L, G, Hp, Wp) CAMs.
    """
    l, p, t = rollout_rows.shape
    hp, wp = patch_hw
    h, w = img_hw
    cams = rollout_rows[:, :, 1:1 + hp * wp][:, assigned_token.long(), :].reshape(l, -1, hp, wp)
    g = cams.shape[1]
    sh, sw = h // cam_stride, w // cam_stride
    binary = normalize_cam(resize(cams, (sh, sw))) >= seed_thr
    if valid is not None:
        binary = binary & valid.bool()[None, :, None, None]
    labels = connected_components_batch(binary.reshape(l * g, sh, sw), max_iters=ccl_iters)
    pts = (gt_points.float() / cam_stride).repeat(l, 1)
    boxes = bbox_from_labels_batch(labels, pts, area_ratio=seed_multiple) * cam_stride
    return boxes.reshape(l, g, 4).transpose(0, 1), cams


class PseudoLabels(NamedTuple):
    map_fg: torch.Tensor  # (G, H, W)
    pseudo_masks: torch.Tensor  # (G, H, W) uint8
    point_coords: torch.Tensor  # (G, NP, 2) xy, -1 = pad
    point_labels: torch.Tensor  # (G, NP) int32 {0 neg, 1 pos, 2 ignore}
    centers: SemanticCenters
    fg_proto: torch.Tensor  # (G+1, D)
    bg_proto: torch.Tensor  # (G, D)


def masks_and_centers(best_cams, vit_feat, boxes, gt_points, gt_labels, valid, pos_mask_thr=0.35,
                      neg_mask_thr=0.8, num_mask_point_gt=10, corr_size=21, obj_tau=0.9,
                      refine_times=2, mean_shift_times=10, num_semantic_points=5, map_stride=1,
                      img_hw=None, matmul_dtype=None, generator=None, points_override=None,
                      gumbel=None) -> PseudoLabels:
    """Stages B+C for one image.

    Args:
        best_cams: (G, H/map_stride, W/map_stride) MIL-selected maps.
        vit_feat: (D, Hp, Wp) patch features.
        boxes: (G, 4) MIL-selected pseudo boxes (full-res coords).
        map_stride: resolution divisor of the Stage-B/C map passes; the
            returned ``map_fg`` and masks are rebuilt exactly at full res.
        img_hw: full-res (H, W); required when ``map_stride > 1``.
        generator: source of the random draws, unless they are given:
        points_override: Stage-B seed points (points_fg, points_bg);
        gumbel: (G, H/map_stride * W/map_stride) noise of the mask-point draw.
    """
    maps = cosine_similarity_refined_map(
        best_cams, vit_feat, boxes, gt_points, valid, thr_pos=0.2, thr_neg=0.1, num_points=20,
        refine_times=refine_times, obj_tau=obj_tau, points_override=points_override,
        stride=map_stride, generator=generator,
    )
    map_fg_full = maps.map_fg
    if map_stride > 1:
        # the refinement ran at patch resolution: rebuilding the pointwise
        # (1 - bg) * fg product at full res from the final patch fields
        # gives the stride-1 map exactly
        ret_full = (1.0 - resize(maps.bg_patch, img_hw)) * resize(maps.fg_patch, img_hw)
        map_fg_full = ret_full / ret_full.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-8)
    mx = map_fg_full.amax(dim=(-2, -1), keepdim=True)
    pseudo_masks = ((map_fg_full > mx * pos_mask_thr) & valid.bool()[:, None, None]).to(torch.uint8)

    pts_xy, pts_lbl = sample_mask_points(
        maps.map_fg, maps.map_bg, boxes, num_gt=num_mask_point_gt, pos_thr=pos_mask_thr,
        neg_thr=neg_mask_thr, corr_size=corr_size, stride=map_stride, generator=generator,
        gumbel=gumbel,
    )
    centers = semantic_centers(
        maps.map_fg, maps.map_bg, boxes, vit_feat, gt_labels, valid, pos_thr=pos_mask_thr,
        n_shift=mean_shift_times, num_semantic_points=num_semantic_points, stride=map_stride,
        matmul_dtype=matmul_dtype,
    )
    # the sampled NEGATIVES stay, semantic centers become the positives;
    # an image with no semantic center at all keeps its sampled positives
    # (`update_coords_with_semantic_centers`, stdroi:125-129)
    has_pt = pts_xy[..., 0] >= 0
    keep = (~pts_lbl & has_pt) | (pts_lbl & has_pt & ~centers.part_valid.any())
    samp_lbl = torch.where(keep, pts_lbl.int(), 2)
    samp_xy = torch.where(keep[..., None], pts_xy, -1.0)
    ctr_lbl = torch.where(centers.part_valid, 1, 2).int()
    ctr_xy = torch.where(centers.part_valid[..., None], centers.coords, -1.0)
    point_coords = torch.cat([samp_xy, ctr_xy], dim=1)
    point_labels = torch.cat([samp_lbl.int(), ctr_lbl], dim=1)
    point_labels = torch.where(valid.bool()[:, None], point_labels, 2).int()
    return PseudoLabels(map_fg_full, pseudo_masks, point_coords, point_labels, centers,
                        maps.fg_proto, maps.bg_proto)
