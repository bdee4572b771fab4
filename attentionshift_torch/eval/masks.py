"""Host-side mask finalisation: paste RoI masks into original-size images.

Reproduces ``get_seg_masks`` (`mae_mask_head_pointSup.py:277-408`): the
28x28 sigmoid mask of each detection is bilinearly pasted into the test
image frame, rescaled to the original image size, thresholded at
``mask_thr_binary`` (0.5). Runs in numpy (eval is host-side in the
reference too).
"""

from __future__ import annotations

import numpy as np

__all__ = ["paste_masks_np", "finalize_detections"]


def paste_masks_np(
    mask_probs: np.ndarray, boxes: np.ndarray, img_h: int, img_w: int
) -> np.ndarray:
    """(N, mh, mw) probs + (N, 4) xyxy -> (N, img_h, img_w) float probs.

    grid_sample(align_corners=False) semantics, zero outside the box.
    """
    n, mh, mw = mask_probs.shape
    out = np.zeros((n, img_h, img_w), np.float32)
    ys = np.arange(img_h, dtype=np.float32) + 0.5
    xs = np.arange(img_w, dtype=np.float32) + 0.5
    for i in range(n):
        x1, y1, x2, y2 = boxes[i, :4]
        if x2 <= x1 or y2 <= y1:
            continue
        gy = (ys - y1) / (y2 - y1) * 2.0 - 1.0
        gx = (xs - x1) / (x2 - x1) * 2.0 - 1.0
        sy = ((gy + 1.0) * mh - 1.0) / 2.0
        sx = ((gx + 1.0) * mw - 1.0) / 2.0
        # only rows/cols that can receive non-zero weight
        ry = np.where((sy > -1.0) & (sy < mh))[0]
        rx = np.where((sx > -1.0) & (sx < mw))[0]
        if len(ry) == 0 or len(rx) == 0:
            continue
        y0 = np.floor(sy[ry]).astype(np.int64)
        x0 = np.floor(sx[rx]).astype(np.int64)
        fy = sy[ry] - y0
        fx = sx[rx] - x0
        m = mask_probs[i]

        def g(yi, xi):
            valid = ((yi >= 0) & (yi < mh))[:, None] & ((xi >= 0) & (xi < mw))[None, :]
            vals = m[np.clip(yi, 0, mh - 1)][:, np.clip(xi, 0, mw - 1)]
            return vals * valid

        patch = (
            g(y0, x0) * ((1 - fy)[:, None] * (1 - fx)[None, :])
            + g(y0, x0 + 1) * ((1 - fy)[:, None] * fx[None, :])
            + g(y0 + 1, x0) * (fy[:, None] * (1 - fx)[None, :])
            + g(y0 + 1, x0 + 1) * (fy[:, None] * fx[None, :])
        )
        out[i, ry[0] : ry[-1] + 1, rx[0] : rx[-1] + 1] = patch
    return out


def finalize_detections(
    boxes: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    valid: np.ndarray,
    mask_probs: np.ndarray,
    scale_wh: np.ndarray,
    orig_wh: np.ndarray,
    mask_thr: float = 0.5,
):
    """Device outputs (one image) -> original-frame detections.

    Boxes are rescaled by 1/scale factor; masks pasted directly in the
    original frame (equivalent to the reference's rescale path).

    Returns dict(boxes (N,4), scores (N,), labels (N,), masks (N,H,W) bool).
    """
    keep = np.asarray(valid, bool)
    boxes = np.asarray(boxes, np.float32)[keep]
    scores = np.asarray(scores, np.float32)[keep]
    labels = np.asarray(labels, np.int64)[keep]
    probs = np.asarray(mask_probs, np.float32)[keep]
    sw, sh = float(scale_wh[0]), float(scale_wh[1])
    ow, oh = int(orig_wh[0]), int(orig_wh[1])
    boxes_orig = boxes / np.asarray([sw, sh, sw, sh], np.float32)
    boxes_orig[:, 0::2] = boxes_orig[:, 0::2].clip(0, ow)
    boxes_orig[:, 1::2] = boxes_orig[:, 1::2].clip(0, oh)
    masks = paste_masks_np(probs, boxes_orig, oh, ow) > mask_thr
    return dict(boxes=boxes_orig, scores=scores, labels=labels, masks=masks)
