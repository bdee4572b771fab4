"""AttnShift detector: the pseudo-label path.

Port of ``AttnShiftDetector`` (``attentionshift_tpu/models/detector.py``)
for ``_extract``, ``_seed``, ``seed_pseudo_gt`` and ``seed_debug``:

  ViT backbone (point tokens, captured attention) -> Stage A (Hungarian
  token match, rollout CAMs, thresholded maps, batched connected
  components, mirrored candidate boxes, MIL best-layer choice) ->
  Stages B+C (refined fg/bg maps, pseudo masks, mask points, mean-shift
  semantic centers).

Instances are padded to ``max_gt`` with validity masks, padded
coordinates are -1 and ignored point labels 2, as in the JAX package.
The model runs on the card unless built with ``device="cpu"``; random
draws come from a ``torch.Generator`` or are handed in per image
(``draws``), so tests can replay the JAX package's draws.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config
from ..device import resolve_device
from ..ops.image import resize
from ..ops.roi_align import roi_align
from ..pseudo.engine import candidate_boxes, masks_and_centers
from ..pseudo.rollout import attention_rollout_point_rows
from ..core.assign import hungarian_point_assign
from .heads import MILHead
from .vit import VisionTransformerDet

__all__ = ["AttnShiftDetector"]

# config keys of the train and test paths, which later slices of the port
# add; the pseudo-label path does not read them
_OTHER_PATHS = frozenset({
    "drop_path_rate", "use_remat", "use_pallas_attention", "use_pallas_ccl",
    "sequence_parallel", "rpn_channels", "num_proposals", "rpn_nms_pre", "rcnn_samples",
    "rcnn_pos_fraction", "mask_sample_cap", "with_keypoint_align", "keypoint_feat_channels",
    "with_reppoints_head", "num_reppoints_head", "with_deform_sup", "reppoints_num_points",
    "reppoints_contour_points", "with_mae_head", "mae_mask_ratio", "test_score_thr",
    "test_iou_thr", "test_max_per_img",
})


class AttnShiftDetector(nn.Module):
    def __init__(self, num_classes: int = 20, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, img_size: int = 224, out_indices=(3, 5, 7, 11),
                 point_tokens: int = 100, cam_layer: int = 7, pad_tokens_to: int = 0,
                 max_gt: int = 20, seed_thr: float = 0.2, seed_multiple: float = 0.5,
                 cam_stride: int = 16, seed_map_stride: int = 4, ccl_iters: int = 64,
                 pos_mask_thr: float = 0.35, neg_mask_thr: float = 0.8,
                 num_mask_point_gt: int = 10, corr_size: int = 21, obj_tau: float = 0.9,
                 refine_times: int = 2, mean_shift_times: int = 10, num_semantic_points: int = 5,
                 dtype: torch.dtype = torch.float32, device=None, **other_paths):
        super().__init__()
        unknown = set(other_paths) - _OTHER_PATHS
        if unknown:
            raise TypeError(f"AttnShiftDetector: unknown arguments {sorted(unknown)}")
        dev = resolve_device(device)
        self.num_classes, self.embed_dim, self.point_tokens = num_classes, embed_dim, point_tokens
        self.cam_layer, self.max_gt = cam_layer, max_gt
        self.seed_thr, self.seed_multiple = seed_thr, seed_multiple
        self.cam_stride, self.seed_map_stride, self.ccl_iters = cam_stride, seed_map_stride, ccl_iters
        self.pos_mask_thr, self.neg_mask_thr = pos_mask_thr, neg_mask_thr
        self.num_mask_point_gt, self.corr_size, self.obj_tau = num_mask_point_gt, corr_size, obj_tau
        self.refine_times, self.mean_shift_times = refine_times, mean_shift_times
        self.num_semantic_points = num_semantic_points
        self.dtype = dtype
        self.backbone = VisionTransformerDet(
            img_size=img_size, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            out_indices=out_indices, point_tokens_num=point_tokens, num_classes=num_classes,
            capture_layers=cam_layer, pad_tokens_to=pad_tokens_to, dtype=dtype,
        )
        self.mil_head = MILHead(num_classes=num_classes, in_channels=embed_dim)
        self.to(dev)
        self.eval()

    @classmethod
    def from_config(cls, path: str, device=None, **overrides) -> "AttnShiftDetector":
        """Build from a config file's ``model`` block plus overrides."""
        kw = Config.fromfile(path).model.to_dict()
        kw.update(overrides)
        return cls(device=device, **kw)

    @property
    def device(self) -> torch.device:
        return self.mil_head.fc1.weight.device

    def init_weights(self, seed: int = 0) -> "AttnShiftDetector":
        """Seeded random init: N(0, 0.02) matrices and tokens, zero biases,
        unit norm scales and running variances."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            for name, t in self.state_dict().items():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("bias", "running_mean"):
                    val = torch.zeros(t.shape)
                elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
                    val = torch.ones(t.shape)
                else:
                    val = torch.randn(t.shape, generator=gen) * 0.02
                t.copy_(val)
        return self

    # ------------------------------------------------------------- shared
    def _extract(self, img):
        out = self.backbone(img)
        b, h, w, _ = img.shape
        hp, wp = h // 16, w // 16
        # roi source: raw last-block patch tokens, BCHW for roi_align
        roi_map = out["last_feat"][:, 1:].reshape(b, hp, wp, self.embed_dim).permute(0, 3, 1, 2)
        return out, roi_map, (hp, wp)

    def _seed(self, out, roi_map, patch_hw, img_hw, gt_points, gt_labels, gt_valid, img_wh,
              generator=None, draws=None, debug=False):
        """Stages A-C (`seed_pseudo_gt`, stdroi:2209-2415)."""
        hp, wp = patch_hw
        h, w = img_hw
        b, g = gt_points.shape[:2]
        dev = roi_map.device
        gt_valid = gt_valid.bool()

        # ---- Stage A: Hungarian token match, rollout CAMs, candidates
        rollout = attention_rollout_point_rows(out["attns"], self.point_tokens,
                                               assume_normalized=True).transpose(0, 1)
        assigned = torch.stack([
            hungarian_point_assign(out["outputs_class"][i], out["outputs_coord"][i],
                                   gt_points[i], gt_labels[i], gt_valid[i], img_wh[i])
            for i in range(b)
        ])  # (B, P) in {0, gt + 1}
        match = assigned[:, None, :] == (torch.arange(g, device=dev)[None, :, None] + 1)
        token_of_gt = match.int().argmax(dim=-1).int()  # (B, G)
        cand, cams = zip(*(
            candidate_boxes(rollout[i], token_of_gt[i], gt_points[i], (hp, wp), (h, w),
                            seed_thr=self.seed_thr, seed_multiple=self.seed_multiple,
                            cam_stride=self.cam_stride, ccl_iters=self.ccl_iters,
                            valid=gt_valid[i])
            for i in range(b)
        ))
        cand = torch.stack(cand)  # (B, G, L, 4)
        cams_patch = torch.stack(cams)  # (B, L, G, Hp, Wp)

        # ---- MIL best-layer selection
        rois = torch.cat([
            torch.arange(b, device=dev, dtype=torch.float32).repeat_interleave(g * self.cam_layer)[:, None],
            cand.reshape(-1, 4),
        ], dim=1)
        mil_feats = roi_align(roi_map, rois, spatial_scale=1.0 / 16, output_size=7)
        mil_feats = mil_feats.permute(0, 2, 3, 1).reshape(b * g, self.cam_layer, 7, 7, -1)
        best_idx, mil_loss = self.mil_head(mil_feats, gt_labels.reshape(-1), gt_valid.reshape(-1))
        best_idx = best_idx.reshape(b, g)
        pseudo_boxes = torch.gather(cand, 2, best_idx.long()[..., None, None].expand(b, g, 1, 4))[:, :, 0]

        # ---- Stages B+C on the patch features
        vit_feat = out["last_feat"][:, 1:].reshape(b, hp, wp, -1).permute(0, 3, 1, 2).float()
        best_cams_patch = torch.gather(
            cams_patch.transpose(1, 2), 2,
            best_idx.long()[:, :, None, None, None].expand(b, g, 1, hp, wp),
        )[:, :, 0]  # (B, G, Hp, Wp)
        ms = self.seed_map_stride
        best_cams = resize(best_cams_patch, (h // ms, w // ms))
        mm = torch.bfloat16 if self.dtype == torch.bfloat16 else None
        pls = []
        for i in range(b):
            dr = draws[i] if draws is not None else {}
            override = (dr["points_fg"], dr["points_bg"]) if "points_fg" in dr else None
            pls.append(masks_and_centers(
                best_cams[i], vit_feat[i], pseudo_boxes[i], gt_points[i], gt_labels[i],
                gt_valid[i], pos_mask_thr=self.pos_mask_thr, neg_mask_thr=self.neg_mask_thr,
                num_mask_point_gt=self.num_mask_point_gt, corr_size=self.corr_size,
                obj_tau=self.obj_tau, refine_times=self.refine_times,
                mean_shift_times=self.mean_shift_times,
                num_semantic_points=self.num_semantic_points, map_stride=ms, img_hw=(h, w),
                matmul_dtype=mm, generator=generator, points_override=override,
                gumbel=dr.get("gumbel"),
            ))
        res = dict(
            pseudo_gt_bboxes=pseudo_boxes,
            pseudo_gt_masks=torch.stack([p.pseudo_masks for p in pls]),
            mask_points_coords=torch.stack([p.point_coords for p in pls]),
            mask_points_labels=torch.stack([p.point_labels for p in pls]),
            map_cos_fg=torch.stack([p.map_fg for p in pls]),
            semantic_centers=torch.stack([p.centers.coords for p in pls]),
            semantic_centers_valid=torch.stack([p.centers.part_valid for p in pls]),
            best_attn_idx=best_idx,
            loss_mil=mil_loss,
        )
        if debug:
            res.update(
                assigned=assigned,
                outputs_coord=out["outputs_coord"],
                outputs_class=out["outputs_class"],
                rollout_rows=rollout,
                candidate_boxes=cand,
                cams=cams_patch,
                best_cams=best_cams_patch,
                token_of_gt=token_of_gt,
                vit_feat=vit_feat,
            )
        return res

    @torch.no_grad()
    def seed_pseudo_gt(self, img, gt_points, gt_labels, gt_valid, img_wh, generator=None,
                       draws=None) -> dict:
        """Pseudo-label generation (the benchmark path).

        Args:
            img: (B, H, W, 3) normalised images; gt_points (B, G, 2) xy;
                gt_labels (B, G); gt_valid (B, G) bool; img_wh (B, 2).
            generator: ``torch.Generator`` on the model's device for the
                random draws (default: torch's default generator).
            draws: optional per-image list of dicts holding the draws
                instead: ``points_fg`` (G+1, 20, 2) and ``points_bg``
                (G, 20, 2) Stage-B seed points, ``gumbel`` (G, H/s * W/s)
                mask-point noise at ``seed_map_stride`` s.
        """
        b, h, w, _ = img.shape
        out, roi_map, patch_hw = self._extract(img)
        res = self._seed(out, roi_map, patch_hw, (h, w), gt_points, gt_labels, gt_valid, img_wh,
                         generator, draws)
        res["pseudo_gt_labels"] = gt_labels
        res["pseudo_gt_valid"] = gt_valid
        return res

    @torch.no_grad()
    def seed_debug(self, img, gt_points, gt_labels, gt_valid, img_wh, generator=None,
                   draws=None) -> dict:
        """``seed_pseudo_gt`` with every intermediate exposed (rollout rows,
        per-layer CAMs and candidates, the match, refined maps, ...)."""
        b, h, w, _ = img.shape
        out, roi_map, patch_hw = self._extract(img)
        return self._seed(out, roi_map, patch_hw, (h, w), gt_points, gt_labels, gt_valid, img_wh,
                          generator, draws, debug=True)
