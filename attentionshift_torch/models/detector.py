"""AttnShift detector: the train forward, the pseudo-label path, inference.

Port of ``AttnShiftDetector`` (``attentionshift_tpu/models/detector.py``):

pseudo labels (``seed_pseudo_gt``, ``seed_debug``):
  ViT backbone (point tokens, captured attention) -> Stage A (Hungarian
  token match, rollout CAMs, thresholded maps, batched connected
  components, mirrored candidate boxes, MIL best-layer choice) ->
  Stages B+C (refined fg/bg maps, pseudo masks, mask points, mean-shift
  semantic centers).

train (``forward``, the JAX ``__call__``):
  the same, with drop path and activation checkpointing in the backbone,
  then the RPN trained on the pseudo boxes, the point-token losses, the
  RCNN box head on sampled proposals and the mask head supervised at the
  sampled points. Returns ``(losses, aux)`` with the JAX package's keys.
  Stage A's selection and Stages B+C build no graph; the MIL bag loss
  keeps its gradient into the backbone. The train variants:
  - ``with_reppoints_head`` (the COCO configs): a cascade of
    ``num_reppoints_head`` RepPoints heads over the detached stride-16
    FPN level, the fg maps re-estimated between stages
    (``refine_fg_maps``); losses ``loss_rp_*`` for stage 0, suffixed
    ``_{i-1}`` for stage i; ``with_deform_sup`` puts the refined centers
    in place of the semantic centers among the mask supervision points;
  - ``with_mae_head``: ``loss_mae_rec``, the MAE reconstruction of the
    re-masked encoder tokens;
  - ``with_keypoint_align``: ``loss_keypoint_align``, each gt's matched
    point token classifying the detached semantic-part features;
  - ``teacher=``: the outputs of an EMA teacher's ``backbone_forward``
    feed the pseudo-label engine; the point losses match the student's
    own detached predictions.

inference (``simple_test``, ``test_from_feats``, and the stages
``rpn_test``, ``roi_test``, ``mask_test`` that multi-scale testing calls):
  backbone without the probability capture (nobody reads the attention
  at test time) -> FPN + RPN proposals -> box head, per-class decoded
  boxes clipped to the true image extent -> multiclass NMS -> mask head
  on the kept boxes. Returns ``TestOutputs`` of fixed shape.

Instances are padded to ``max_gt`` with validity masks, padded
coordinates are -1 and ignored point labels 2, as in the JAX package.
The model runs on the card unless built with ``device="cpu"``; random
draws come from a ``torch.Generator`` or are handed in per image
(``draws``), so tests can replay the JAX package's draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..config import Config
from ..core.anchors import grid_anchors, grid_anchors_per_level
from ..core.assign import hungarian_point_assign, max_iou_assign, random_sample
from ..core.boxes import delta2bbox
from ..core.losses import l1_loss, sigmoid_focal_loss
from ..core.postprocess import Detections, multiclass_nms
from ..device import resolve_device
from ..ops.image import resize
from ..ops.roi_align import roi_align
from ..ops.sampling import point_sample
from ..ops.topk import top_k_stable
from ..parallel.mesh import global_count
from ..pseudo.engine import candidate_boxes, masks_and_centers
from ..pseudo.rollout import attention_rollout_point_rows
from .condinst import SimpleCondInstHead
from .fpn import FPN
from .heads import BoxHeadRec, MaskHeadPointSup, MILHead, mask_point_loss
from .mae_head import MAEDecoderHead
from .reppoints import RepPointsPartHead, contour_points, refine_fg_maps
from .rpn import RPNHead, rpn_loss, rpn_proposals
from .vit import VisionTransformerDet

__all__ = ["AttnShiftDetector", "TestOutputs"]


class TestOutputs(NamedTuple):
    __test__ = False  # not a pytest class

    dets: Detections  # batched: boxes (B, K, 4), scores/labels/valid (B, K)
    mask_probs: torch.Tensor  # (B, K, 28, 28) sigmoid probs of the predicted class


# config keys this port does not read: switches of the JAX package's own
# kernels and meshes
_OTHER_PATHS = frozenset({"use_pallas_attention", "use_pallas_ccl", "sequence_parallel"})


class AttnShiftDetector(nn.Module):
    def __init__(self, num_classes: int = 20, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, img_size: int = 224, out_indices=(3, 5, 7, 11),
                 point_tokens: int = 100, cam_layer: int = 7, pad_tokens_to: int = 0,
                 max_gt: int = 20, seed_thr: float = 0.2, seed_multiple: float = 0.5,
                 cam_stride: int = 16, seed_map_stride: int = 4, ccl_iters: int = 64,
                 pos_mask_thr: float = 0.35, neg_mask_thr: float = 0.8,
                 num_mask_point_gt: int = 10, corr_size: int = 21, obj_tau: float = 0.9,
                 refine_times: int = 2, mean_shift_times: int = 10, num_semantic_points: int = 5,
                 drop_path_rate: float = 0.05, use_remat: bool = True, rpn_channels: int = 256,
                 num_proposals: int = 1000, rpn_nms_pre: int = 2000, rcnn_samples: int = 512,
                 rcnn_pos_fraction: float = 0.25, mask_sample_cap: int = 128,
                 test_score_thr: float = 0.05, test_iou_thr: float = 0.5,
                 test_max_per_img: int = 100, with_keypoint_align: bool = False,
                 keypoint_feat_channels: int = 8, with_reppoints_head: bool = False,
                 num_reppoints_head: int = 1, with_deform_sup: bool = False,
                 reppoints_num_points: int = 9, reppoints_contour_points: int = 16,
                 with_mae_head: bool = False, mae_mask_ratio: float = 0.75,
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
        self.num_proposals, self.rpn_nms_pre = num_proposals, rpn_nms_pre
        self.rcnn_samples, self.rcnn_pos_fraction = rcnn_samples, rcnn_pos_fraction
        self.mask_sample_cap = mask_sample_cap
        self.test_score_thr, self.test_iou_thr = test_score_thr, test_iou_thr
        self.test_max_per_img = test_max_per_img
        self.dtype = dtype
        self.backbone = VisionTransformerDet(
            img_size=img_size, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            out_indices=out_indices, point_tokens_num=point_tokens, num_classes=num_classes,
            capture_layers=cam_layer, pad_tokens_to=pad_tokens_to,
            drop_path_rate=drop_path_rate, use_remat=use_remat, dtype=dtype,
        )
        self.mil_head = MILHead(num_classes=num_classes, in_channels=embed_dim)
        self.neck = FPN(in_channels=embed_dim, out_channels=rpn_channels, num_outs=5)
        self.rpn_head = RPNHead(feat_channels=rpn_channels)
        self.bbox_head = BoxHeadRec(num_classes=num_classes, in_channels=embed_dim)
        self.mask_head = MaskHeadPointSup(num_classes=num_classes, in_channels=embed_dim)
        if with_keypoint_align:
            self.keypoint_align_head = SimpleCondInstHead(embed_dim, embed_dim,
                                                          feat_channels=keypoint_feat_channels)
        # the cascade's heads under the JAX package's names, reppoints_head_i
        self.num_reppoints_head = num_reppoints_head if with_reppoints_head else 0
        self.with_deform_sup = with_deform_sup
        self.reppoints_contour_points = reppoints_contour_points
        for i in range(self.num_reppoints_head):
            setattr(self, f"reppoints_head_{i}",
                    RepPointsPartHead(in_channels=rpn_channels, num_points=reppoints_num_points))
        if with_mae_head:
            self.mae_head = MAEDecoderHead(in_channels=embed_dim, mask_ratio=mae_mask_ratio)
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
        unit norm scales and running variances; the FPN convs Xavier-uniform
        and the RPN convs N(0, 0.01), as mmdet initialises them."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            for name, t in self.state_dict().items():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("bias", "running_mean"):
                    val = torch.zeros(t.shape)
                elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
                    val = torch.ones(t.shape)
                elif name.startswith("rpn_head."):
                    val = torch.randn(t.shape, generator=gen) * 0.01
                elif name.startswith("neck."):
                    taps = 9 if t.dim() == 4 else 1
                    bound = (6.0 / (taps * (t.shape[-1] + t.shape[-2]))) ** 0.5
                    val = (torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound
                else:
                    val = torch.randn(t.shape, generator=gen) * 0.02
                t.copy_(val)
        return self

    # ------------------------------------------------------------- shared
    def _extract(self, img, deterministic: bool = True, generator=None, drop_masks=None,
                 with_features: bool = False, capture: bool = True):
        out = self.backbone(img, with_features=with_features, deterministic=deterministic,
                            generator=generator, drop_masks=drop_masks, capture=capture)
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
        with torch.no_grad():
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
        # the candidates were made without a graph, so the pseudo boxes carry
        # none; Stages B+C read the patch features detached
        with torch.no_grad():
            res, dbg, protos = self._stages_bc(out, cams_patch, pseudo_boxes, best_idx, patch_hw,
                                               img_hw, gt_points, gt_labels, gt_valid, generator,
                                               draws)
        res.update(pseudo_gt_bboxes=pseudo_boxes, best_attn_idx=best_idx, loss_mil=mil_loss)
        if debug:
            res.update(
                assigned=assigned,
                outputs_coord=out["outputs_coord"],
                outputs_class=out["outputs_class"],
                rollout_rows=rollout,
                candidate_boxes=cand,
                cams=cams_patch,
                token_of_gt=token_of_gt,
                **dbg,
            )
        return res, assigned, protos

    def _stages_bc(self, out, cams_patch, pseudo_boxes, best_idx, patch_hw, img_hw, gt_points,
                   gt_labels, gt_valid, generator, draws):
        """Stages B+C on the detached patch features (no graph): the
        public outputs, the debug intermediates, and what the train
        variants read besides (the Stage-B prototypes, the parts' features)."""
        hp, wp = patch_hw
        h, w = img_hw
        b, g = gt_points.shape[:2]
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
        return dict(
            pseudo_gt_masks=torch.stack([p.pseudo_masks for p in pls]),
            mask_points_coords=torch.stack([p.point_coords for p in pls]),
            mask_points_labels=torch.stack([p.point_labels for p in pls]),
            map_cos_fg=torch.stack([p.map_fg for p in pls]),
            semantic_centers=torch.stack([p.centers.coords for p in pls]),
            semantic_centers_valid=torch.stack([p.centers.part_valid for p in pls]),
        ), dict(best_cams=best_cams_patch, vit_feat=vit_feat), dict(
            fg_proto=torch.stack([p.fg_proto for p in pls]),  # (B, G + 1, D)
            bg_proto=torch.stack([p.bg_proto for p in pls]),  # (B, G, D)
            part_feats=torch.stack([p.centers.feats for p in pls]),  # (B, G, P, D)
        )

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
                         generator, draws)[0]
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
                          generator, draws, debug=True)[0]

    # -------------------------------------------------------------- train
    @torch.no_grad()
    def backbone_forward(self, img) -> dict:
        """The backbone alone, deterministic and without a graph: the EMA
        teacher's share of a train step, whose output ``forward`` takes as
        ``teacher``."""
        return self._extract(img)[0]

    def forward(self, img, gt_points, gt_labels, gt_valid, img_wh, *, loss_enable=1.0,
                teacher=None, generator=None, draws=None, drop_masks=None):
        """Training forward: returns (losses dict, aux dict).

        Args:
            img: (B, H, W, 3) normalised, padded images; gt_points (B, G, 2)
                annotated xy; gt_labels (B, G); gt_valid (B, G) bool; img_wh
                (B, 2) true (w, h) before padding.
            loss_enable: epoch-gated switch of the bbox and mask losses.
            teacher: optional ``backbone_forward`` output of an EMA teacher,
                which then feeds the pseudo-label engine (the student's
                backbone runs without the probability capture).
            generator: ``torch.Generator`` on the model's device for every
                random draw of the step.
            draws: optional per-image list of dicts holding draws instead:
                those of ``seed_pseudo_gt``, ``rpn_u_pos``/``rpn_u_neg``
                (one uniform per anchor), ``rcnn_u_pos``/``rcnn_u_neg``
                (one per gt + proposal; ``rcnn_u_pos`` also orders the
                sampled rois, as the JAX package reuses that key),
                ``mask_u`` (one per sampled roi); for the variants
                ``rp_contour_{i}`` (G, H*W) Gumbel noise of cascade stage
                i's contour points, ``rp_bg_{i}`` (H*W,) that of stage i's
                background supplement (i > 0), ``mae_noise`` (N,) the MAE
                masking uniforms over the N patches.
            drop_masks: optional (depth, 2, B) drop-path keep masks.
        """
        b, h, w, _ = img.shape
        gt_valid = gt_valid.bool()
        out, roi_map, patch_hw = self._extract(img, deterministic=False, generator=generator,
                                               drop_masks=drop_masks, capture=teacher is None)
        seed, assigned, protos = self._seed(teacher if teacher is not None else out, roi_map,
                                            patch_hw, (h, w), gt_points, gt_labels, gt_valid,
                                            img_wh, generator, draws)
        if teacher is not None:
            # the point losses match the student's own predictions
            with torch.no_grad():
                assigned = torch.stack([
                    hungarian_point_assign(out["outputs_class"][i], out["outputs_coord"][i],
                                           gt_points[i], gt_labels[i], gt_valid[i], img_wh[i])
                    for i in range(b)])
        pseudo_boxes = seed["pseudo_gt_bboxes"]
        losses = {"loss_mil": seed["loss_mil"]}
        dr = draws if draws is not None else [{}] * b

        # ---- RPN on pseudo boxes
        fpn_feats = self.neck(out["feature"])
        cls_scores, bbox_preds = self.rpn_head(fpn_feats)
        sizes = [tuple(f.shape[1:3]) for f in fpn_feats]
        rpn_draws = None if draws is None else [
            {k[4:]: v for k, v in d.items() if k.startswith("rpn_")} for d in draws]
        losses.update(rpn_loss(cls_scores, bbox_preds, grid_anchors(sizes, device=img.device),
                               pseudo_boxes, gt_valid, generator=generator, draws=rpn_draws))
        props = rpn_proposals(cls_scores, bbox_preds,
                              grid_anchors_per_level(sizes, device=img.device), (h, w),
                              nms_pre=self.rpn_nms_pre, max_per_img=self.num_proposals)

        losses.update(self._point_losses(out["outputs_class"].float(), out["outputs_coord"].float(),
                                         assigned, gt_points, gt_labels, img_wh))
        mask_pt_coords, mask_pt_labels = seed["mask_points_coords"], seed["mask_points_labels"]
        if self.num_reppoints_head:
            rp_losses, centers, cvalid = self._cascade(fpn_feats[2], out, patch_hw, seed, protos,
                                                       gt_valid, generator, dr)
            losses.update(rp_losses)
            if self.with_deform_sup:
                # the refined centers replace the semantic centers, the last
                # P supervision points of each instance
                p = centers.shape[2]
                mask_pt_coords = torch.cat([mask_pt_coords[:, :, :-p],
                                            torch.where(cvalid[..., None], centers, -1.0)], dim=2)
                mask_pt_labels = torch.cat([mask_pt_labels[:, :, :-p],
                                            torch.where(cvalid, 1, 2).to(mask_pt_labels.dtype)],
                                           dim=2)
        losses.update(self._rcnn_losses(roi_map, props, pseudo_boxes, gt_labels, gt_valid,
                                        mask_pt_coords, mask_pt_labels, loss_enable, generator,
                                        draws))
        if hasattr(self, "mae_head"):
            noise = torch.stack([d["mae_noise"] for d in dr]) if "mae_noise" in dr[0] else None
            losses["loss_mae_rec"] = self.mae_head(out["last_feat"], img, generator=generator,
                                                   noise=noise)
        if hasattr(self, "keypoint_align_head"):
            losses.update(self._keypoint_loss(out["point_tokens"], assigned, protos["part_feats"],
                                              seed["semantic_centers_valid"], gt_valid))
        aux = dict(
            pseudo_boxes=pseudo_boxes,
            pseudo_valid=gt_valid,
            pseudo_masks=seed["pseudo_gt_masks"],
            best_idx=seed["best_attn_idx"],
            semantic_centers=seed["semantic_centers"],
            semantic_valid=seed["semantic_centers_valid"],
            map_fg=seed["map_cos_fg"],
        )
        return losses, aux

    def _cascade(self, rp_level, out, patch_hw, seed, protos, gt_valid, generator, dr):
        """The RepPoints cascade on the detached stride-16 FPN level and
        patch features: (losses, refined centers (B, G, P, 2), their
        validity (B, G, P))."""
        hp, wp = patch_hw
        b = rp_level.shape[0]
        rp_feats = rp_level.detach()
        vit_feat = out["last_feat"][:, 1:].detach().reshape(b, hp, wp, -1).permute(0, 3, 1, 2).float()
        boxes = seed["pseudo_gt_bboxes"].float()
        centers, cvalid = seed["semantic_centers"], seed["semantic_centers_valid"]
        fg_maps, rp_masks = seed["map_cos_fg"], seed["pseudo_gt_masks"]
        losses = {}
        for i in range(self.num_reppoints_head):
            with torch.no_grad():
                if i > 0:  # the fg maps re-estimated from the refined centers
                    fg_maps, rp_masks = (torch.stack(t) for t in zip(*(
                        refine_fg_maps(fg_maps[j], vit_feat[j], boxes[j], centers[j], cvalid[j],
                                       protos["fg_proto"][j], protos["bg_proto"][j], gt_valid[j],
                                       generator=generator, pos_mask_thr=self.pos_mask_thr,
                                       gumbel=dr[j].get(f"rp_bg_{i}"))
                        for j in range(b))))
                cont_xy, cont_val = (torch.stack(t) for t in zip(*(
                    contour_points(rp_masks[j], self.reppoints_contour_points, generator,
                                   dr[j].get(f"rp_contour_{i}"))
                    for j in range(b))))
            rpo = getattr(self, f"reppoints_head_{i}")(rp_feats, boxes, centers, cvalid, gt_valid,
                                                       rp_masks, fg_maps, cont_xy, cont_val)
            suffix = "" if i == 0 else f"_{i - 1}"
            losses.update({k + suffix: v for k, v in rpo.losses.items()})
            centers, cvalid = rpo.new_centers, rpo.new_valid
        return losses, centers, cvalid

    def _keypoint_loss(self, point_tokens, assigned, part_feats, part_valid, gt_valid) -> dict:
        """Each gt's matched point token (the one-hot match's argmax)
        classifies the detached semantic-part features of every instance."""
        b, g, npart, d = part_feats.shape
        match = assigned[:, None, :] == (torch.arange(g, device=assigned.device)[None, :, None] + 1)
        token_of_gt = match.int().argmax(dim=-1)  # (B, G)
        tokens = torch.gather(point_tokens, 1, token_of_gt[..., None].expand(b, g, point_tokens.shape[-1]))
        owner = torch.arange(g, device=assigned.device).repeat_interleave(npart)[None].expand(b, -1)
        pvalid = part_valid.reshape(b, g * npart) & torch.gather(gt_valid, 1, owner)
        return self.keypoint_align_head(tokens, part_feats.reshape(b, g * npart, d).detach(), owner,
                                        pvalid, gt_valid)

    def _roi_feats(self, roi_map, boxes, output_size):
        """(B, N, 4) boxes -> (B*N, S, S, C) channel-last roi features."""
        b, n, _ = boxes.shape
        idx = torch.arange(b, device=boxes.device, dtype=boxes.dtype).repeat_interleave(n)
        rois = torch.cat([idx[:, None], boxes.reshape(b * n, 4)], dim=1)
        feats = roi_align(roi_map, rois, spatial_scale=1.0 / 16, output_size=output_size)
        return feats.permute(0, 2, 3, 1)

    def _point_losses(self, point_cls, point_reg, assigned, gt_points, gt_labels, img_wh):
        b, p, c = point_cls.shape
        g = gt_points.shape[1]
        matched = assigned > 0  # (B, P)
        gt_idx = (assigned - 1).clamp(0, g - 1).long()
        labels = torch.where(matched, torch.gather(gt_labels.long(), 1, gt_idx), self.num_classes)
        num_pos = global_count(matched.sum().float())
        loss_cls = sigmoid_focal_loss(point_cls.reshape(-1, c), labels.reshape(-1),
                                      avg_factor=num_pos)
        tgt_xy = torch.gather(gt_points.float(), 1, gt_idx[..., None].expand(b, p, 2)) \
            / img_wh.float()[:, None, :]
        loss_pt = l1_loss(point_reg, tgt_xy, weight=matched.float()[..., None], avg_factor=num_pos)
        hit = (point_cls.reshape(-1, c).argmax(-1) == labels.reshape(-1)) & matched.reshape(-1)
        return {"loss_point_cls": loss_cls, "loss_point": 10.0 * loss_pt,
                "pos_point_acc": hit.sum() / num_pos * 100.0}

    def _sample_rois(self, boxes, valid, gts, glbl, gval, u_pos, u_neg, generator):
        """One image's RCNN samples: gts are added to the proposals,
        MaxIoU-assigned at 0.5, randomly sampled, and gathered to a fixed
        size with the positives first. The selection builds no graph; the
        gathered rois keep the proposals' (see ``rpn_proposals``)."""
        g, s = gts.shape[0], self.rcnn_samples
        all_boxes = torch.cat([gts, boxes], dim=0)
        with torch.no_grad():
            all_valid = torch.cat([gval, valid], dim=0)
            assign = max_iou_assign(all_boxes, gts, glbl, gval, pos_iou_thr=0.5, neg_iou_thr=0.5,
                                    min_pos_iou=0.5, match_low_quality=False)
            assigned = torch.where(all_valid, assign.assigned_gt, -1)
            if u_pos is None:
                u_pos = torch.rand(assigned.shape[0], device=boxes.device, generator=generator)
            samp = random_sample(assigned, s, self.rcnn_pos_fraction, u_pos=u_pos, u_neg=u_neg,
                                 generator=generator)
            # the ordering score takes the positives' uniforms again, as the
            # JAX package's sampler derives both from one key
            score = samp.pos_mask.float() * 2.0 + samp.neg_mask.float() \
                + u_pos.to(boxes.device).float() * 0.5
            idx = top_k_stable(score, s)[1]
            r_pos, r_neg = samp.pos_mask[idx], samp.neg_mask[idx]
            gt_slot = (assigned[idx] - 1).clamp(0, g - 1).long()
            r_lbl = torch.where(r_pos, glbl.long()[gt_slot], self.num_classes)
        return all_boxes[idx], r_lbl, gts[gt_slot], r_pos, r_neg, gt_slot

    def _rcnn_losses(self, roi_map, props, pseudo_boxes, gt_labels, gt_valid, mask_pt_coords,
                     mask_pt_labels, loss_enable, generator, draws):
        b, g = pseudo_boxes.shape[:2]
        s = self.rcnn_samples
        dev = roi_map.device
        dr = draws if draws is not None else [{}] * b
        rois, labels, tgts, pos, neg, pgt = (torch.stack(t) for t in zip(*(
            self._sample_rois(props.boxes[i], props.valid[i], pseudo_boxes[i].float(),
                              gt_labels[i], gt_valid[i], dr[i].get("rcnn_u_pos"),
                              dr[i].get("rcnn_u_neg"), generator)
            for i in range(b))))

        roi_feats = self._roi_feats(roi_map, rois, 7)  # (B*S, 7, 7, D)
        cls_score, bbox_pred, _ = self.bbox_head(roi_feats)
        lw = (pos | neg).reshape(-1).float()
        bw = pos.reshape(-1).float()[:, None].expand(-1, 4)
        losses = self.bbox_head.loss(cls_score, bbox_pred, rois.reshape(-1, 4), labels.reshape(-1),
                                     lw, tgts.reshape(-1, 4), bw, loss_enable=loss_enable)

        # ---- mask head on positive rois only (fixed cap)
        m = min(self.mask_sample_cap, s)
        with torch.no_grad():
            pidx = []
            for i in range(b):
                u = dr[i].get("mask_u")
                if u is None:
                    u = torch.rand(s, device=dev, generator=generator)
                pidx.append(top_k_stable(pos[i].float() + u.to(dev).float() * 0.5, m)[1])
            pidx = torch.stack(pidx)  # (B, M)
            pvalid = torch.gather(pos, 1, pidx)
            mlabels = torch.gather(labels, 1, pidx)
            mgt = torch.gather(pgt, 1, pidx)  # (B, M) matched gt slot
            # per-roi supervision points from the matched gt
            npnt = mask_pt_coords.shape[2]
            pts = torch.gather(mask_pt_coords, 1, mgt[..., None, None].expand(b, m, npnt, 2))
            plbl = torch.gather(mask_pt_labels, 1, mgt[..., None].expand(b, m, npnt))
        mrois = torch.gather(rois, 1, pidx[..., None].expand(b, m, 4))
        # box-normalised coords; outside [0, 1] -> ignore
        wh_box = (mrois[..., 2:4] - mrois[..., 0:2]).clamp_min(1e-6)
        rel = (pts - mrois[..., None, 0:2]) / wh_box[..., None, :]
        outside = (rel[..., 0] < 0) | (rel[..., 0] > 1) | (rel[..., 1] < 0) | (rel[..., 1] > 1)
        plbl = torch.where(outside, 2, plbl)

        mask_logits = self.mask_head(self._roi_feats(roi_map, mrois, 14))  # (B*M, 28, 28, C)
        preds = point_sample(mask_logits.permute(0, 3, 1, 2), rel.reshape(b * m, npnt, 2))
        losses["loss_mask"] = mask_point_loss(
            preds.transpose(1, 2), plbl.reshape(b * m, npnt),
            mlabels.clamp(0, self.num_classes - 1).reshape(-1), pvalid.reshape(-1),
            loss_enable=loss_enable)
        return losses

    # ---------------------------------------------------- aug-test stages
    def _test_proposals(self, out, img_hw):
        fpn_feats = self.neck(out["feature"])
        cls_scores, bbox_preds = self.rpn_head(fpn_feats)
        sizes = [tuple(f.shape[1:3]) for f in fpn_feats]
        return rpn_proposals(cls_scores, bbox_preds,
                             grid_anchors_per_level(sizes, device=fpn_feats[0].device), img_hw,
                             nms_pre=1000, max_per_img=self.num_proposals)

    @torch.no_grad()
    def rpn_test(self, img):
        """Backbone + RPN proposals in this augmentation's frame."""
        b, h, w, _ = img.shape
        out, _, _ = self._extract(img, with_features=True, capture=False)
        return self._test_proposals(out, (h, w))

    def _decode_rois(self, roi_map, rois, img_wh):
        """Box head on (B, R, 4) rois: softmax scores (B, R, C + 1) and the
        per-class decoded boxes (B, R, C, 4), clipped to the true extent."""
        b, r = rois.shape[:2]
        cls_score, bbox_pred, _ = self.bbox_head(self._roi_feats(roi_map, rois, 7))
        scores = torch.softmax(cls_score.float(), dim=-1).reshape(b, r, -1)
        deltas = bbox_pred.float().reshape(b, r, self.num_classes, 4)
        decoded = delta2bbox(rois[:, :, None, :].float(), deltas, stds=(0.1, 0.1, 0.2, 0.2))
        return scores, self._clip_to_wh(decoded, img_wh)

    @torch.no_grad()
    def roi_test(self, img, rois, img_wh):
        """Box head on given rois: softmax scores + per-class decoded boxes.

        ``rois``: (B, R, 4) in this augmentation's frame; ``img_wh``:
        (B, 2) true (w, h) of that frame before padding. Decoded boxes
        clip to the true extent, never the padded canvas: the same
        semantics as ``simple_test``.
        """
        _, roi_map, _ = self._extract(img, capture=False)
        return self._decode_rois(roi_map, rois, img_wh)

    @staticmethod
    def _clip_to_wh(boxes, img_wh):
        """Clip (B, ..., 4) xyxy boxes to per-image true (w, h)."""
        shape = (-1,) + (1,) * (boxes.dim() - 2)
        zero = boxes.new_zeros(())
        wmax = img_wh[:, 0].to(boxes.dtype).reshape(shape)
        hmax = img_wh[:, 1].to(boxes.dtype).reshape(shape)
        return torch.stack([boxes[..., 0].clamp(zero, wmax), boxes[..., 1].clamp(zero, hmax),
                            boxes[..., 2].clamp(zero, wmax), boxes[..., 3].clamp(zero, hmax)],
                           dim=-1)

    def _mask_probs(self, roi_map, rois, labels):
        """Mask head on (B, R, 4) rois -> (B, R, 28, 28) sigmoid
        probabilities of each roi's class ``labels`` (B, R)."""
        b, r = rois.shape[:2]
        logits = self.mask_head(self._roi_feats(roi_map, rois, 14))  # (B*R, 28, 28, C)
        probs = torch.sigmoid(logits.float()).reshape(b, r, *logits.shape[1:])
        sel = labels.long()[..., None, None, None].expand(b, r, *logits.shape[1:3], 1)
        return torch.gather(probs, -1, sel)[..., 0]

    @torch.no_grad()
    def mask_test(self, img, rois, labels):
        """Mask head on given rois -> (B, R, 28, 28) probs of ``labels``."""
        _, roi_map, _ = self._extract(img, capture=False)
        return self._mask_probs(roi_map, rois, labels)

    # --------------------------------------------------------------- test
    @torch.no_grad()
    def simple_test(self, img, img_wh) -> TestOutputs:
        """Single-scale inference. ``img_wh``: (B, 2) true (w, h).

        The backbone runs deterministically and without the probability
        capture: 12 plain attention launches per image on the card.
        """
        b, h, w, _ = img.shape
        out, roi_map, _ = self._extract(img, with_features=True, capture=False)
        return self.test_from_feats(out, roi_map, img_wh, (h, w))

    def test_from_feats(self, out, roi_map, img_wh, img_hw) -> TestOutputs:
        """``simple_test`` from precomputed backbone outputs.

        Split out so that CAM tools can differentiate the detection score
        with respect to the backbone activations: it sets no ``no_grad``
        itself, and with ``roi_map`` requiring grad the scores and mask
        probabilities carry a graph back to it (the selections, top-k and
        NMS, build none).
        """
        b = roi_map.shape[0]
        n = self.num_proposals
        props = self._test_proposals(out, img_hw)
        scores, decoded = self._decode_rois(roi_map, props.boxes, img_wh)  # (B, N, C, 4)
        dets = [multiclass_nms(decoded[i].reshape(n, -1), scores[i], self.test_score_thr,
                               self.test_iou_thr, self.test_max_per_img,
                               box_valid=props.valid[i]) for i in range(b)]
        dets = Detections(*(torch.stack(t) for t in zip(*dets)))
        return TestOutputs(dets=dets, mask_probs=self._mask_probs(roi_map, dets.boxes, dets.labels))
