"""COCO-style instance-segmentation AP (AP@[.5:.95], AP50, AP75).

pycocotools-free reimplementation of COCOeval's segm protocol (the
reference evaluates COCO with pycocotools through mmdet's CocoDataset):
per (class, image) greedy matching of score-ordered detections to GTs at
10 IoU thresholds, crowd regions matchable-but-unscored, 101-point
precision interpolation, maxDets=100. RLE IoU runs in the native C++
toolkit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import native

__all__ = ["coco_segm_eval"]

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)


def _match_image(pred_rles, pred_scores, gt_rles, gt_crowd, iou_thrs):
    """Greedy COCO matching for one (class, image).

    Returns (matched (T, Np) bool, ignored (T, Np) bool) per threshold.
    """
    npred, ngt = len(pred_rles), len(gt_rles)
    t = len(iou_thrs)
    matched = np.zeros((t, npred), bool)
    ignored = np.zeros((t, npred), bool)
    if npred == 0:
        return matched, ignored
    order = np.argsort(-np.asarray(pred_scores), kind="stable")
    gt_crowd = np.asarray(gt_crowd, bool)
    # COCOeval iterates GTs ignored-LAST (stable): a detection takes any
    # qualifying non-crowd GT before considering a crowd region, even at
    # lower IoU; crowd IoU itself is intersection-over-det-area.
    gorder = np.argsort(gt_crowd, kind="stable")
    if ngt:
        iou = native.rle_iou_matrix(
            [pred_rles[i] for i in order],
            [gt_rles[g] for g in gorder],
            iscrowd_b=gt_crowd[gorder],
        )  # (Np, Ng) in (score, ignored-last) order
        crowd_sorted = gt_crowd[gorder]
    for ti, thr in enumerate(iou_thrs):
        gt_used = np.zeros(ngt, bool)
        for pi in range(npred):
            if ngt == 0:
                break
            best, best_iou = -1, thr
            for gi in range(ngt):
                if gt_used[gi] and not crowd_sorted[gi]:
                    continue
                # best already non-crowd and we've reached the crowd
                # tail: stop (COCOeval's break)
                if best >= 0 and not crowd_sorted[best] and crowd_sorted[gi]:
                    break
                if iou[pi, gi] >= best_iou:
                    best, best_iou = gi, iou[pi, gi]
            if best >= 0:
                if crowd_sorted[best]:
                    ignored[ti, order[pi]] = True
                else:
                    gt_used[best] = True
                    matched[ti, order[pi]] = True
    return matched, ignored


def coco_segm_eval(
    pred_masks: Sequence[np.ndarray],
    pred_labels: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_masks: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    num_classes: int,
    gt_iscrowd: Sequence[np.ndarray] | None = None,
    max_dets: int = 100,
):
    """COCO segm AP over per-image prediction/GT lists (binary masks).

    Returns dict(AP, AP50, AP75, per_class (C,) array).
    """
    n_img = len(pred_masks)
    if gt_iscrowd is None:
        gt_iscrowd = [np.zeros(len(g), bool) for g in gt_labels]

    # per class accumulation
    per_class_ap = np.full((num_classes, len(IOU_THRS)), np.nan)
    for c in range(num_classes):
        scores_all, matched_all, ignored_all = [], [], []
        n_gt = 0
        for i in range(n_img):
            psel = np.where(pred_labels[i] == c)[0]
            order = np.argsort(-pred_scores[i][psel], kind="stable")[:max_dets]
            psel = psel[order]
            gsel = np.where(gt_labels[i] == c)[0]
            crowd = gt_iscrowd[i][gsel]
            n_gt += int((~crowd).sum())
            if len(psel) == 0:
                continue
            pred_rles = [native.rle_encode(pred_masks[i][j]) for j in psel]
            gt_rles = [native.rle_encode(gt_masks[i][j]) for j in gsel]
            m, ig = _match_image(
                pred_rles, pred_scores[i][psel], gt_rles, crowd, IOU_THRS
            )
            scores_all.append(pred_scores[i][psel])
            matched_all.append(m)
            ignored_all.append(ig)
        if n_gt == 0:
            continue
        if not scores_all:
            per_class_ap[c] = 0.0
            continue
        scores = np.concatenate(scores_all)
        matched = np.concatenate(matched_all, axis=1)
        ignored = np.concatenate(ignored_all, axis=1)
        order = np.argsort(-scores, kind="stable")
        for ti in range(len(IOU_THRS)):
            m = matched[ti, order]
            ig = ignored[ti, order]
            keep = ~ig
            tp = np.cumsum(m[keep])
            fp = np.cumsum(~m[keep])
            rec = tp / n_gt
            prec = tp / np.maximum(tp + fp, 1)
            # precision envelope + 101-point interpolation
            for k in range(len(prec) - 2, -1, -1):
                prec[k] = max(prec[k], prec[k + 1])
            if len(prec) == 0:
                # every det for this class was crowd-ignored
                per_class_ap[c, ti] = 0.0
                continue
            idx = np.searchsorted(rec, RECALL_THRS, side="left")
            q = np.where(idx < len(prec), prec[np.minimum(idx, len(prec) - 1)], 0.0)
            per_class_ap[c, ti] = q.mean()

    mean_over = lambda arr: float(np.nanmean(arr)) if np.isfinite(arr).any() else 0.0
    ap = mean_over(per_class_ap)
    ap50 = mean_over(per_class_ap[:, 0])
    ap75 = mean_over(per_class_ap[:, 5])
    return dict(
        AP=ap, AP50=ap50, AP75=ap75,
        per_class=np.nanmean(per_class_ap, axis=1),
    )
