"""Multi-scale + flip augmented inference (the reference eval protocol).

Port of ``attentionshift_tpu/eval/aug_test.py``, the two-stage
``aug_test`` path (`mmdet/models/detectors/two_stage_point_sup.py:302`,
6 scales x flip, `configs/_base_/datasets/voc_instance_aug.py:39-53`):

1. RPN proposals from every augmentation, mapped back to the original
   frame and merged with NMS at 0.7 (``merge_aug_proposals``);
2. the box head scores the shared proposal set under every augmentation;
   scores and decoded boxes are averaged in the original frame
   (``merge_aug_bboxes``), clipped, then multiclass NMS -> detections;
3. the mask head runs per augmentation on the detected boxes; sigmoid
   probabilities are un-flipped and averaged (``merge_aug_masks``).

Each device stage is one of the detector's ``rpn_test``, ``roi_test``,
``mask_test``, so the backbone runs once per stage and augmentation.
Between stages the tensors stay on the model's device: the flip and
scale arithmetic the JAX version does in numpy is the same f32
arithmetic here, and the proposals of all augmentations are merged
without a host read. The valid proposals are moved to the front in
augmentation order (a stable sort on validity), the invalid ones zeroed
and scored -1, so the merge NMS sees the JAX version's candidate list
followed by rows it never keeps. The result is read to the host once, as
numpy, like the JAX version's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.postprocess import multiclass_nms
from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD, _pad_to, _resize_keep_ratio
from ..ops.nms import nms

__all__ = ["AugTester"]


def _flip_boxes(boxes, aw: int):
    """xyxy boxes (..., 4) mirrored in a frame of width ``aw``."""
    return torch.stack([aw - boxes[..., 2], boxes[..., 1], aw - boxes[..., 0], boxes[..., 3]],
                       dim=-1)


class AugTester:
    """``model``: an ``AttnShiftDetector`` (it owns its parameters, so
    there is no ``params`` argument as in the JAX version)."""

    def __init__(self, model, scales: Sequence[tuple[int, int]], flip: bool = True,
                 size_divisor: int = 32):
        self.model = model
        self.scales = list(scales)
        self.flips = [False, True] if flip else [False]
        self.size_divisor = size_divisor

    def _augment(self, img: np.ndarray, scale, flip):
        aug, wf, hf = _resize_keep_ratio(img, scale)
        if flip:
            aug = aug[:, ::-1]
        h, w = aug.shape[:2]
        pad = lambda v: (v + self.size_divisor - 1) // self.size_divisor * self.size_divisor  # noqa: E731
        norm = (aug.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
        padded = _pad_to(norm, pad(h), pad(w))
        return padded, (wf, hf), (w, h)

    @torch.no_grad()
    def __call__(self, img: np.ndarray, max_dets: int = 100):
        """img: (H, W, 3) uint8 original image. Returns original-frame
        detections dict(boxes, scores, labels, valid, mask_probs) as numpy."""
        model = self.model
        dev = model.device
        orig_h, orig_w = img.shape[:2]
        augs = []
        for scale in self.scales:
            for flip in self.flips:
                padded, (wf, hf), awh = self._augment(img, scale, flip)
                augs.append(dict(img=torch.from_numpy(padded[None]).to(dev), awh=awh, flip=flip,
                                 sf=torch.tensor([wf, hf, wf, hf], dtype=torch.float32,
                                                 device=dev)))

        def to_aug(boxes, a):
            """Original-frame boxes -> augmentation ``a``'s frame."""
            boxes = boxes * a["sf"]
            return _flip_boxes(boxes, a["awh"][0]) if a["flip"] else boxes

        def from_aug(boxes, a):
            if a["flip"]:
                boxes = _flip_boxes(boxes, a["awh"][0])
            return boxes / a["sf"]

        # --- stage 1: merged proposals in the original frame
        all_boxes, all_scores, all_valid = [], [], []
        for a in augs:
            props = model.rpn_test(a["img"])
            all_boxes.append(from_aug(props.boxes[0].float(), a))
            all_scores.append(props.scores[0].float())
            all_valid.append(props.valid[0].bool())
        valid = torch.cat(all_valid)
        front = torch.sort((~valid).int(), stable=True).indices
        valid = valid[front]
        pb = torch.where(valid[:, None], torch.cat(all_boxes)[front], 0.0)
        ps = torch.where(valid, torch.cat(all_scores)[front], -1.0)
        # every augmentation gives num_proposals rows, so the list is never
        # shorter than the JAX version's padding to num_proposals
        keep_idx, merged_valid = nms(pb, ps, 0.7, model.num_proposals, valid=ps > -1)
        merged = pb[keep_idx.long()]

        # --- stage 2: average box-head outputs over augs
        sum_scores = None
        sum_boxes = None
        for a in augs:
            awh = torch.tensor([a["awh"]], dtype=torch.float32, device=dev)
            scores, decoded = model.roi_test(a["img"], to_aug(merged, a)[None], awh)
            scores = scores[0]  # (R, C+1)
            boxes = from_aug(decoded[0], a)  # (R, C, 4)
            sum_scores = scores if sum_scores is None else sum_scores + scores
            sum_boxes = boxes if sum_boxes is None else sum_boxes + boxes
        avg_scores = sum_scores / len(augs)
        avg_boxes = sum_boxes / len(augs)
        avg_boxes = torch.stack([avg_boxes[..., 0].clamp(0, orig_w),
                                 avg_boxes[..., 1].clamp(0, orig_h),
                                 avg_boxes[..., 2].clamp(0, orig_w),
                                 avg_boxes[..., 3].clamp(0, orig_h)], dim=-1)

        dets = multiclass_nms(avg_boxes.reshape(len(merged), -1), avg_scores,
                              model.test_score_thr, model.test_iou_thr, max_dets,
                              box_valid=merged_valid)

        # --- stage 3: average mask probs over augs
        sum_masks = None
        for a in augs:
            probs = model.mask_test(a["img"], to_aug(dets.boxes, a)[None],
                                    dets.labels[None])[0]  # (K, 28, 28)
            if a["flip"]:
                probs = torch.flip(probs, dims=[-1])
            sum_masks = probs if sum_masks is None else sum_masks + probs
        mask_probs = sum_masks / len(augs)

        return dict(
            boxes=dets.boxes.cpu().numpy(),
            scores=dets.scores.cpu().numpy(),
            labels=dets.labels.cpu().numpy(),
            valid=dets.valid.cpu().numpy(),
            mask_probs=mask_probs.cpu().numpy(),
        )
