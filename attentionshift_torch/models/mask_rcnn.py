"""Standard Mask R-CNN for the pseudo-label refinement stage.

Port of ``attentionshift_tpu/models/mask_rcnn.py``: the stock
ResNet-FPN Mask R-CNN (mmdet ``mask_rcnn_r50_fpn_1x``) that the paper's
AttnShift-dagger rows retrain on the pseudo labels of
``tools/gen_pseudo_labels``: anchor RPN, shared-2FC box head, FCN mask
head, one train loss; ``with_mask=False`` is the plain Faster R-CNN.

train (``forward``, the JAX ``__call__``): RPN loss against the boxes,
proposals, gts added to them, MaxIoU assignment at 0.5, random sampling
of ``rcnn_samples`` RoIs, softmax CE + class-specific smooth-L1 on the
deltas, the mask head on up to ``mask_sample_cap`` positive RoIs against
28x28 RoIAlign crops of the matched ``mask_stride`` bitmaps (>= 0.5).

inference (``simple_test`` and the stages ``rpn_test``, ``roi_test``,
``mask_test`` that ``eval.aug_test.AugTester`` calls): the same
contract as ``AttnShiftDetector``'s, so ``eval.runner.evaluate`` drives
either model.

FPN level routing is mmdet's ``map_roi_levels``: ``floor(log2(sqrt(area)
/ 224 + 1e-6)) + 4`` clipped to P2..P5. The JAX module crops every RoI
from all four levels and selects one; here each RoI is cropped from its
own level only, which gives the same outputs and gradients (the
unselected crops get none).

The model runs in f32, as the JAX module does. Random draws come from a
``torch.Generator`` or are handed in per image (``draws``) with the keys
of ``AttnShiftDetector.forward``: ``rpn_u_pos``/``rpn_u_neg``,
``rcnn_u_pos``/``rcnn_u_neg`` (``rcnn_u_pos`` also orders the sampled
RoIs: the JAX package draws that score from the positives' key) and
``mask_u``. Under a data-parallel step (``parallel.mesh.data_parallel``)
the RCNN and mask normalisers are counted over the global batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.anchors import grid_anchors, grid_anchors_per_level
from ..core.assign import max_iou_assign, random_sample
from ..core.boxes import bbox2delta, delta2bbox
from ..core.losses import smooth_l1_loss
from ..core.postprocess import Detections, multiclass_nms
from ..device import resolve_device
from ..ops.roi_align import roi_align
from ..ops.topk import top_k_stable
from ..parallel.mesh import global_count
from .fpn import FPN
from .layers import Conv3x3Matmul, Deconv2x2Matmul, Dense
from .resnet import ResNet
from .rpn import RPNHead, rpn_loss, rpn_proposals

__all__ = ["MaskRCNN", "StdBoxHead", "StdMaskHead", "MaskRCNNTestOutputs", "roi_levels"]

REG_STDS = (0.1, 0.1, 0.2, 0.2)  # mmdet DeltaXYWHBBoxCoder target_stds


class StdBoxHead(nn.Module):
    """mmdet ``Shared2FCBBoxHead``: flatten 7x7 RoIs -> 2 fc(1024) ->
    softmax cls (C+1) + class-specific box deltas (4C)."""

    def __init__(self, num_classes: int = 20, in_channels: int = 256, roi_size: int = 7,
                 fc_channels: int = 1024):
        super().__init__()
        self.fc1 = Dense(roi_size * roi_size * in_channels, fc_channels)
        self.fc2 = Dense(fc_channels, fc_channels)
        self.fc_cls = Dense(fc_channels, num_classes + 1)
        self.fc_reg = Dense(fc_channels, num_classes * 4)

    def forward(self, roi_feats):
        """(N, 7, 7, C) channel-last -> cls (N, C+1), reg (N, 4C), f32."""
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.fc2(F.relu(self.fc1(x))))
        return self.fc_cls(x).float(), self.fc_reg(x).float()


class StdMaskHead(nn.Module):
    """mmdet ``FCNMaskHead``: 4x conv3x3(256) -> deconv x2 -> 1x1 conv."""

    def __init__(self, num_classes: int = 20, in_channels: int = 256, conv_channels: int = 256):
        super().__init__()
        for i in range(4):  # conv1..conv4, the flax names
            setattr(self, f"conv{i + 1}",
                    Conv3x3Matmul(in_channels if i == 0 else conv_channels, conv_channels))
        self.upsample = Deconv2x2Matmul(conv_channels, conv_channels)
        self.conv_logits = Dense(conv_channels, num_classes)

    def forward(self, roi_feats):
        """(N, 14, 14, C) -> logits (N, 28, 28, num_classes), f32."""
        x = roi_feats
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        x = F.relu(self.upsample(x))
        return self.conv_logits(x).float()


class MaskRCNNTestOutputs(NamedTuple):
    __test__ = False  # not a pytest class

    # field names match ``detector.TestOutputs`` so the eval runner works
    # with either model
    dets: Detections  # boxes (B, K, 4), scores/labels/valid (B, K)
    mask_probs: torch.Tensor  # (B, K, 28, 28) probabilities of the det class


def roi_levels(boxes):
    """mmdet ``map_roi_levels``: (N, 4) xyxy -> (N,) level index 0..3 over
    P2..P5, ``floor(log2(sqrt(area) / 224 + 1e-6)) + 4`` clipped."""
    wh = (boxes[:, 2:4] - boxes[:, 0:2]).clamp_min(1e-6)
    scale = torch.sqrt(wh[:, 0] * wh[:, 1])
    lvl = torch.floor(torch.log2(scale / 224.0 + 1e-6)) + 4
    return lvl.clamp(2, 5).long() - 2


class MaskRCNN(nn.Module):
    def __init__(self, num_classes: int = 20, rpn_channels: int = 256, num_proposals: int = 1000,
                 rpn_nms_pre: int = 2000, rcnn_samples: int = 512,
                 rcnn_pos_fraction: float = 0.25, mask_sample_cap: int = 128,
                 mask_stride: int = 4, with_mask: bool = True, depths=(3, 4, 6, 3),
                 frozen_stages: int = 1, test_score_thr: float = 0.05,
                 test_iou_thr: float = 0.5, test_max_per_img: int = 100, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes, self.num_proposals, self.rpn_nms_pre = num_classes, num_proposals, rpn_nms_pre
        self.rcnn_samples, self.rcnn_pos_fraction = rcnn_samples, rcnn_pos_fraction
        self.mask_sample_cap, self.mask_stride, self.with_mask = mask_sample_cap, mask_stride, with_mask
        self.test_score_thr, self.test_iou_thr = test_score_thr, test_iou_thr
        self.test_max_per_img = test_max_per_img
        self.dtype = torch.float32  # as the JAX module runs
        self.backbone = ResNet(depths=depths, frozen_stages=frozen_stages)
        self.neck = FPN(in_channels=self.backbone.out_channels, out_channels=rpn_channels,
                        num_outs=5)
        self.rpn_head = RPNHead(feat_channels=rpn_channels)
        self.bbox_head = StdBoxHead(num_classes=num_classes, in_channels=rpn_channels)
        if with_mask:
            self.mask_head = StdMaskHead(num_classes=num_classes, in_channels=rpn_channels)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.bbox_head.fc1.weight.device

    def init_weights(self, seed: int = 0) -> "MaskRCNN":
        """Seeded random init: N(0, 0.01) for the RPN and the box head's
        outputs, Kaiming-normal (fan out) for the backbone and mask convs,
        Xavier-uniform for the FPN and the box head's fcs, zero biases;
        the frozen BNs are identities."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            for name, t in self.state_dict().items():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("bias", "running_mean") or t.dim() == 1:
                    val = torch.ones(t.shape) if leaf in ("weight", "running_var") else torch.zeros(t.shape)
                elif name.startswith("rpn_head.") or name.startswith("bbox_head.fc_"):
                    val = torch.randn(t.shape, generator=gen) * 0.01
                elif name.startswith(("neck.", "bbox_head.")):
                    fan_in, fan_out = _fans(name, t)
                    bound = (6.0 / (fan_in + fan_out)) ** 0.5
                    val = (torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound
                else:
                    _, fan_out = _fans(name, t)
                    val = torch.randn(t.shape, generator=gen) * (2.0 / fan_out) ** 0.5
                t.copy_(val)
        return self

    # ------------------------------------------------------------- shared
    def _features(self, img):
        return self.neck(self.backbone(img))  # P2..P6

    def _roi_feats(self, fpn_feats, boxes, output_size):
        """FPN-routed RoIAlign (mmdet ``SingleRoIExtractor``): (B, N, 4)
        boxes -> (B*N, S, S, C) channel-last, each RoI cropped from its
        ``roi_levels`` level only."""
        b, n, _ = boxes.shape
        idx = torch.arange(b, device=boxes.device, dtype=boxes.dtype).repeat_interleave(n)
        rois = torch.cat([idx[:, None], boxes.reshape(b * n, 4)], dim=1)
        with torch.no_grad():
            lvl = roi_levels(rois[:, 1:5])
        c = fpn_feats[0].shape[-1]
        out = fpn_feats[0].new_zeros(b * n, c, output_size, output_size)
        for i in range(4):
            sel = (lvl == i).nonzero()[:, 0]
            if sel.numel():
                crops = roi_align(fpn_feats[i].permute(0, 3, 1, 2), rois[sel],
                                  spatial_scale=1.0 / (4 * 2**i), output_size=output_size,
                                  sampling_ratio=2)
                out = out.index_put((sel,), crops)
        return out.permute(0, 2, 3, 1)

    # -------------------------------------------------------------- train
    def forward(self, img, gt_boxes, gt_labels, gt_masks, gt_valid, img_wh, *, loss_enable=1.0,
                generator=None, draws=None):
        """Fully supervised training forward on (pseudo) labels; returns
        (losses, aux) with the JAX package's keys.

        Args:
            img: (B, H, W, 3) normalised padded images.
            gt_boxes: (B, G, 4) xyxy; gt_labels: (B, G); gt_valid (B, G) bool.
            gt_masks: (B, G, H/mask_stride, W/mask_stride) uint8 bitmaps.
            img_wh: (B, 2) true (w, h) (unused by the losses, as in JAX).
            generator: ``torch.Generator`` on the model's device for the
                samplers' draws; ``draws``: per-image dicts of them instead.
        """
        b, h, w, _ = img.shape
        g = gt_boxes.shape[1]
        s = self.rcnn_samples
        gt_valid = gt_valid.bool()
        gt_boxes = gt_boxes.float()
        dr = draws if draws is not None else [{}] * b

        fpn_feats = self._features(img)
        cls_scores, bbox_preds = self.rpn_head(fpn_feats)
        sizes = [tuple(f.shape[1:3]) for f in fpn_feats]
        rpn_draws = None if draws is None else [
            {k[4:]: v for k, v in d.items() if k.startswith("rpn_")} for d in draws]
        losses = dict(rpn_loss(cls_scores, bbox_preds, grid_anchors(sizes, device=img.device),
                               gt_boxes, gt_valid, generator=generator, draws=rpn_draws))
        props = rpn_proposals(cls_scores, bbox_preds,
                              grid_anchors_per_level(sizes, device=img.device), (h, w),
                              nms_pre=self.rpn_nms_pre, max_per_img=self.num_proposals)

        rois, labels, tgts, pos, neg, pgt = (torch.stack(t) for t in zip(*(
            self._sample_rois(props.boxes[i], props.valid[i], gt_boxes[i], gt_labels[i],
                              gt_valid[i], dr[i].get("rcnn_u_pos"), dr[i].get("rcnn_u_neg"),
                              generator)
            for i in range(b))))

        # ---- box head: softmax CE + class-specific smooth-L1 on deltas
        cls_score, bbox_pred = self.bbox_head(self._roi_feats(fpn_feats, rois, 7))
        flat_lbl = labels.reshape(-1)
        lw = (pos | neg).reshape(-1).float()
        n_samp = global_count(lw.sum())
        # the JAX module weights the MEAN over every row by the sampled share
        nll = -torch.gather(torch.log_softmax(cls_score, -1), 1, flat_lbl[:, None])[:, 0]
        losses["loss_cls"] = nll.mean() * (global_count(lw.sum(), floor=0.0) / n_samp) * loss_enable
        hit = (cls_score.argmax(-1) == flat_lbl).float() * lw
        losses["rcnn_acc"] = hit.sum() / n_samp * 100.0
        deltas_t = bbox2delta(rois.reshape(-1, 4), tgts.reshape(-1, 4), stds=REG_STDS)
        reg = bbox_pred.reshape(-1, self.num_classes, 4)
        sel = flat_lbl.clamp(0, self.num_classes - 1)[:, None, None].expand(-1, 1, 4)
        reg_c = torch.gather(reg, 1, sel)[:, 0]
        pw = pos.reshape(-1).float()
        losses["loss_bbox"] = ((smooth_l1_loss(reg_c, deltas_t, beta=1.0).sum(-1) * pw).sum()
                               / n_samp * loss_enable)
        if self.with_mask:
            losses["loss_mask"] = self._mask_loss(fpn_feats, rois, labels, pos, pgt, gt_masks, dr,
                                                  generator) * loss_enable
        return losses, dict(rois=rois, pos=pos)

    def _sample_rois(self, boxes, valid, gts, glbl, gval, u_pos, u_neg, generator):
        """One image's RCNN samples: gts are added to the proposals,
        MaxIoU-assigned at 0.5, randomly sampled, and gathered to a fixed
        size with the positives first. The selection builds no graph; the
        gathered RoIs keep the proposals' (see ``rpn_proposals``)."""
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
            # JAX package draws both from one key
            score = samp.pos_mask.float() * 2.0 + samp.neg_mask.float() \
                + u_pos.to(boxes.device).float() * 0.5
            idx = top_k_stable(score, s)[1]
            r_pos, r_neg = samp.pos_mask[idx], samp.neg_mask[idx]
            gt_slot = (assigned[idx] - 1).clamp(0, g - 1).long()
            r_lbl = torch.where(r_pos, glbl.long()[gt_slot], self.num_classes)
        return all_boxes[idx], r_lbl, gts[gt_slot], r_pos, r_neg, gt_slot

    def _mask_loss(self, fpn_feats, rois, labels, pos, pgt, gt_masks, dr, generator):
        """BCE of the mask head on a fixed cap of positive RoIs (clamped to
        the sampled-RoI count) against their matched gt bitmap's 28x28
        RoIAlign crop thresholded at 0.5."""
        b, s = pos.shape
        m = min(self.mask_sample_cap, s)
        dev = rois.device
        with torch.no_grad():
            pidx = []
            for i in range(b):
                u = dr[i].get("mask_u")
                if u is None:
                    u = torch.rand(s, device=dev, generator=generator)
                pidx.append(top_k_stable(pos[i].float() + u.to(dev).float() * 0.5, m)[1])
            pidx = torch.stack(pidx)  # (B, M)
            pvalid = torch.gather(pos, 1, pidx)
            mlabels = torch.gather(labels, 1, pidx).clamp(0, self.num_classes - 1)
            mgt = torch.gather(pgt, 1, pidx)  # (B, M) matched gt slot
        mrois = torch.gather(rois, 1, pidx[..., None].expand(b, m, 4))
        logits = self.mask_head(self._roi_feats(fpn_feats, mrois, 14))  # (B*M, 28, 28, C)
        sel = mlabels.reshape(-1)[:, None, None, None].expand(-1, *logits.shape[1:3], 1)
        logits_c = torch.gather(logits, 3, sel)[..., 0]
        with torch.no_grad():
            mh, mw = gt_masks.shape[2:]
            own = torch.gather(gt_masks, 1, mgt[..., None, None].expand(b, m, mh, mw))
            own = own.reshape(b * m, 1, mh, mw).float()
            crop_rois = torch.cat([torch.arange(b * m, device=dev, dtype=torch.float32)[:, None],
                                   mrois.detach().reshape(-1, 4) / self.mask_stride], dim=1)
            tgt = roi_align(own, crop_rois, 1.0, output_size=28, sampling_ratio=2)
            tgt = (tgt[:, 0] >= 0.5).float()
        bce = logits_c.clamp_min(0) - logits_c * tgt + torch.log1p(torch.exp(-logits_c.abs()))
        mw_ = pvalid.reshape(-1).float()
        return (bce.mean(dim=(1, 2)) * mw_).sum() / global_count(mw_.sum())

    # ---------------------------------------------------- aug-test stages
    def _proposals(self, fpn_feats, img_hw):
        cls_scores, bbox_preds = self.rpn_head(fpn_feats)
        sizes = [tuple(f.shape[1:3]) for f in fpn_feats]
        return rpn_proposals(cls_scores, bbox_preds,
                             grid_anchors_per_level(sizes, device=fpn_feats[0].device), img_hw,
                             nms_pre=1000, max_per_img=self.num_proposals)

    @torch.no_grad()
    def rpn_test(self, img):
        """Backbone + RPN proposals in this augmentation's frame."""
        return self._proposals(self._features(img), tuple(img.shape[1:3]))

    def _decode_rois(self, fpn_feats, rois, img_wh):
        """Box head on (B, R, 4) RoIs: softmax scores (B, R, C + 1) and the
        per-class decoded boxes (B, R, C, 4), clipped to the true extent."""
        b, r = rois.shape[:2]
        cls_score, bbox_pred = self.bbox_head(self._roi_feats(fpn_feats, rois, 7))
        scores = torch.softmax(cls_score, dim=-1).reshape(b, r, -1)
        deltas = bbox_pred.reshape(b, r, self.num_classes, 4)
        decoded = delta2bbox(rois[:, :, None, :].float(), deltas, stds=REG_STDS)
        return scores, _clip_to_wh(decoded, img_wh)

    @torch.no_grad()
    def roi_test(self, img, rois, img_wh):
        """Box head on given RoIs: softmax scores + per-class decoded boxes,
        clipped to ``img_wh`` (B, 2), the true (w, h) of this frame."""
        return self._decode_rois(self._features(img), rois, img_wh)

    def _mask_probs(self, fpn_feats, rois, labels):
        b, r = rois.shape[:2]
        if not self.with_mask:  # Faster R-CNN: full-box masks
            return torch.ones(b, r, 28, 28, device=rois.device)
        logits = self.mask_head(self._roi_feats(fpn_feats, rois, 14))  # (B*R, 28, 28, C)
        probs = torch.sigmoid(logits).reshape(b, r, *logits.shape[1:])
        sel = labels.long()[..., None, None, None].expand(b, r, *logits.shape[1:3], 1)
        return torch.gather(probs, -1, sel)[..., 0]

    @torch.no_grad()
    def mask_test(self, img, rois, labels):
        """Mask head on given RoIs -> (B, R, 28, 28) probs of ``labels``."""
        return self._mask_probs(self._features(img) if self.with_mask else None, rois, labels)

    # --------------------------------------------------------------- test
    @torch.no_grad()
    def simple_test(self, img, img_wh) -> MaskRCNNTestOutputs:
        """Single-scale inference: (B, K) detections + 28x28 mask
        probabilities (the host pastes them). ``img_wh``: (B, 2) true (w, h)."""
        b = img.shape[0]
        n = self.num_proposals
        fpn_feats = self._features(img)
        props = self._proposals(fpn_feats, tuple(img.shape[1:3]))
        scores, decoded = self._decode_rois(fpn_feats, props.boxes, img_wh)
        dets = [multiclass_nms(decoded[i].reshape(n, -1), scores[i], self.test_score_thr,
                               self.test_iou_thr, self.test_max_per_img,
                               box_valid=props.valid[i]) for i in range(b)]
        dets = Detections(*(torch.stack(t) for t in zip(*dets)))
        return MaskRCNNTestOutputs(dets=dets,
                                   mask_probs=self._mask_probs(fpn_feats, dets.boxes, dets.labels))


def _clip_to_wh(boxes, img_wh):
    """Clip (B, ..., 4) xyxy boxes to per-image true (w, h)."""
    shape = (-1,) + (1,) * (boxes.dim() - 2)
    zero = boxes.new_zeros(())
    wmax = img_wh[:, 0].to(boxes.dtype).reshape(shape)
    hmax = img_wh[:, 1].to(boxes.dtype).reshape(shape)
    return torch.stack([boxes[..., 0].clamp(zero, wmax), boxes[..., 1].clamp(zero, hmax),
                        boxes[..., 2].clamp(zero, wmax), boxes[..., 3].clamp(zero, hmax)], dim=-1)


def _fans(name: str, t: torch.Tensor) -> tuple[int, int]:
    """(fan in, fan out) of a weight in the port's layouts: Linear (out,
    in); conv (Cout, Cin, kh, kw); matmul-form 3x3 (3, 3, Cin, Cout);
    deconv (Cin, Cout, 2, 2)."""
    if t.dim() == 2:
        return t.shape[1], t.shape[0]
    if t.shape[:2] == (3, 3) and "backbone" not in name:
        return 9 * t.shape[2], 9 * t.shape[3]
    if "upsample" in name:
        return 4 * t.shape[1], 4 * t.shape[0]
    taps = t.shape[2] * t.shape[3]
    return taps * t.shape[1], taps * t.shape[0]
