"""VOC-style instance-segmentation mAP (the reference's ``mAP_Segm``).

Reimplements `mmdet/core/evaluation/mean_ap_segm.py:114-166`, which
delegates to chainercv's ``calc_instance_segmentation_voc_prec_rec`` +
``calc_detection_voc_ap`` (07 metric). chainercv is unavailable here, so
the algorithm is written out directly, chainercv-exact:

per image and class: sort that image's predictions by score; each
prediction's match is the ARGMAX-IoU ground truth — if that GT passes
``iou_thresh`` and is unclaimed the prediction is a TP, otherwise an FP
(chainercv does NOT re-match a prediction to its second-best GT when
the best is already claimed; this matters for crowded same-class
scenes). Globally per class: re-sort (score, match) pairs by score,
cumulate precision/recall, AP = 11-point interpolation (VOC2007) or
area-under-PR (use_07_metric=False); mAP = nanmean over classes.

Fuzz-verified against an independent brute-force oracle transcribed
from the chainercv algorithm (tests/test_data_eval.py, VERDICT round-2
item 3).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence

import numpy as np

__all__ = ["mask_iou", "eval_map_segm", "voc_ap"]


def mask_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, H, W) x (M, H, W) boolean masks -> (N, M) IoU."""
    n, m = len(pred), len(gt)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float64)
    p = pred.reshape(n, -1).astype(np.float64)
    g = gt.reshape(m, -1).astype(np.float64)
    inter = p @ g.T
    union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return inter / np.maximum(union, 1.0)


def voc_ap(prec: np.ndarray, rec: np.ndarray, use_07_metric: bool = True) -> float:
    if len(prec) == 0:
        return float("nan")
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t]
            ap += (p.max() if len(p) else 0.0) / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def eval_map_segm(
    pred_masks: Sequence[np.ndarray],
    pred_labels: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_masks: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    num_classes: int,
    iou_thresh: float = 0.5,
    use_07_metric: bool = True,
):
    """Args (one entry per image):
        pred_masks[i]: (Ni, H, W) bool; pred_labels[i]: (Ni,);
        pred_scores[i]: (Ni,); gt_masks[i]: (Mi, H, W) bool;
        gt_labels[i]: (Mi,).

    Returns (mAP, per-class AP array (num_classes,), per-class stats).
    """
    # per class: score list and match flags
    scores = defaultdict(list)
    matches = defaultdict(list)
    n_gt = np.zeros((num_classes,), np.int64)

    for pm, pl, ps, gm, gl in zip(
        pred_masks, pred_labels, pred_scores, gt_masks, gt_labels
    ):
        for c in range(num_classes):
            n_gt[c] += int((gl == c).sum())
        for c in np.unique(pl).tolist() if len(pl) else []:
            sel = np.where(pl == c)[0]
            # per-image score sort (chainercv: ``argsort()[::-1]``)
            sel = sel[np.asarray(ps[sel]).argsort(kind="stable")[::-1]]
            gsel = np.where(gl == c)[0]
            gts = gm[gsel] if len(gsel) else np.zeros((0,) + (gm.shape[1:] if len(gm) else (1, 1)), bool)
            preds = np.stack([pm[i] for i in sel])
            scores[c].extend(float(ps[i]) for i in sel)
            if len(gsel) == 0:
                matches[c].extend([0] * len(sel))
                continue
            iou = mask_iou(preds, gts)
            # chainercv matching: each prediction is judged against its
            # single ARGMAX-IoU gt only; a claimed gt makes it an FP
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1
            used = np.zeros(len(gsel), bool)
            for j in gt_index:
                if j >= 0:
                    matches[c].append(0 if used[j] else 1)
                    used[j] = True
                else:
                    matches[c].append(0)

    aps = np.full((num_classes,), np.nan)
    for c in range(num_classes):
        if n_gt[c] == 0:
            continue
        if not scores[c]:
            aps[c] = 0.0
            continue
        sc = np.asarray(scores[c])
        mt = np.asarray(matches[c])
        order = sc.argsort(kind="stable")[::-1]
        tp = np.cumsum(mt[order])
        fp = np.cumsum(1 - mt[order])
        rec = tp / n_gt[c]
        prec = tp / np.maximum(tp + fp, 1)
        aps[c] = voc_ap(prec, rec, use_07_metric)

    mean_ap = float(np.nanmean(aps)) if np.isfinite(aps).any() else 0.0
    return mean_ap, aps, dict(num_gts=n_gt)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU (numpy, eval-side)."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None] - inter, 1e-10)


def eval_map(
    pred_boxes: Sequence[np.ndarray],
    pred_labels: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    num_classes: int,
    iou_thresh: float = 0.5,
    use_07_metric: bool = True,
):
    """VOC-style BOX mAP (the reference's ``eval_map``,
    `mmdet/core/evaluation/mean_ap.py` stock path) — identical matching
    to ``eval_map_segm`` with box IoU."""
    scores = defaultdict(list)
    matches = defaultdict(list)
    n_gt = np.zeros((num_classes,), np.int64)
    for pb, pl, ps, gb, gl in zip(
        pred_boxes, pred_labels, pred_scores, gt_boxes, gt_labels
    ):
        for c in range(num_classes):
            n_gt[c] += int((gl == c).sum())
        for c in np.unique(pl).tolist() if len(pl) else []:
            sel = np.where(pl == c)[0]
            sel = sel[np.asarray(ps[sel]).argsort(kind="stable")[::-1]]
            gsel = np.where(gl == c)[0]
            scores[c].extend(float(ps[i]) for i in sel)
            if len(gsel) == 0:
                matches[c].extend([0] * len(sel))
                continue
            iou = box_iou_np(pb[sel], gb[gsel])
            # chainercv matching (see eval_map_segm): argmax-only, no
            # re-match to a second-best unclaimed gt
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1
            used = np.zeros(len(gsel), bool)
            for j in gt_index:
                if j >= 0:
                    matches[c].append(0 if used[j] else 1)
                    used[j] = True
                else:
                    matches[c].append(0)
    aps = np.full((num_classes,), np.nan)
    for c in range(num_classes):
        if n_gt[c] == 0:
            continue
        if not scores[c]:
            aps[c] = 0.0
            continue
        sc = np.asarray(scores[c])
        mt = np.asarray(matches[c])
        order = sc.argsort(kind="stable")[::-1]
        tp = np.cumsum(mt[order])
        fp = np.cumsum(1 - mt[order])
        rec = tp / n_gt[c]
        prec = tp / np.maximum(tp + fp, 1)
        aps[c] = voc_ap(prec, rec, use_07_metric)
    mean_ap = float(np.nanmean(aps)) if np.isfinite(aps).any() else 0.0
    return mean_ap, aps
