"""Detection CAM visualisation: grad-CAM, EigenCAM and FeatmapAM.

Port of ``attentionshift_tpu/utils/det_cam.py``: a differentiable
box-match score target (``det_box_score``), grad-CAM through the
detector's ``test_from_feats`` split, the gradient-free EigenCAM and the
channel-mean FeatmapAM, and the overlay of a CAM on its image.

grad-CAM differentiates the match score of the focal boxes with respect
to ``roi_map``, the last block's patch tokens that the RoI heads read,
with ``torch.autograd.grad`` on whatever device the detector is on (the
backbone runs once, without a graph). ``grad_cam`` hands the heads f32
features whatever the backbone's dtype, so they compute in f32 (their
weights are f32): through bf16 heads the map's channel weights move by
about their own size (0.92 of it in relative norm on an H100 at 800 x
1344, ``chip_smoke.py``'s ``phase_det_cam``). ``eigen_cam`` and
``featmap_am`` are tensor functions that compute where their input
lies; ``cam_on_image`` is host PIL code.
"""

from __future__ import annotations

import numpy as np
import torch

from .visualize import _np, overlay_heatmap

__all__ = ["det_box_score", "grad_cam", "grad_cam_from_feats", "eigen_cam", "featmap_am",
           "cam_on_image"]


def _pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (x[:, 2] - x[:, 0]).clamp_min(0) * (x[:, 3] - x[:, 1]).clamp_min(0)

    return inter / (area(a)[:, None] + area(b)[None] - inter).clamp_min(1e-6)


def det_box_score(det_boxes, det_scores, det_labels, det_valid, focal_boxes, focal_labels,
                  det_masks=None, focal_masks=None, match_iou_thr: float = 0.5) -> torch.Tensor:
    """Differentiable ``DetBoxScoreTarget``: each focal box adds its best-IoU
    valid detection's IoU + score (+ the masks' overlap inter / (a + b)
    when masks are given) if that IoU exceeds ``match_iou_thr`` and the
    labels match, else 0; the scalar sum over focal boxes."""
    det_boxes, focal_boxes = det_boxes.float(), focal_boxes.to(det_boxes.device).float()
    ious = torch.where(det_valid[None, :], _pairwise_iou(focal_boxes, det_boxes), 0.0)
    best = torch.argmax(ious, dim=1)  # (F,)
    best_iou = torch.gather(ious, 1, best[:, None])[:, 0]
    ok = (best_iou > match_iou_thr) & (det_labels[best] == focal_labels.to(det_labels.device))
    score = torch.where(ok, best_iou + det_scores[best].float(), 0.0)
    if det_masks is not None and focal_masks is not None:
        dm = det_masks[best].float()  # (F, h, w)
        fm = focal_masks.to(dm.device).float()
        inter = (fm * dm).sum(dim=(1, 2))
        denom = fm.sum(dim=(1, 2)) + dm.sum(dim=(1, 2)) + 1e-7
        score = score + torch.where(ok, inter / denom, 0.0)
    return score.sum()


def grad_cam_from_feats(model, out: dict, roi_map: torch.Tensor, img_wh, img_hw,
                        focal_boxes, focal_labels, match_iou_thr: float = 0.5) -> torch.Tensor:
    """grad-CAM from precomputed backbone outputs (``model._extract``):
    weights = the spatial mean of d(score)/d(roi_map) per channel, cam =
    relu(sum_c w_c * act_c) / max. Returns the (Hp, Wp) f32 cam of image
    0, on ``roi_map``'s device."""
    rm = roi_map.detach().requires_grad_(True)
    with torch.enable_grad():
        t = model.test_from_feats(out, rm, img_wh, img_hw)
        score = det_box_score(t.dets.boxes[0], t.dets.scores[0], t.dets.labels[0],
                              t.dets.valid[0], focal_boxes, focal_labels,
                              match_iou_thr=match_iou_thr)
        (grads,) = torch.autograd.grad(score, rm)
    act = roi_map[0].detach().float()  # (D, Hp, Wp)
    weights = grads[0].float().mean(dim=(1, 2))
    cam = (weights[:, None, None] * act).sum(0).clamp_min(0.0)
    return cam / cam.max().clamp_min(1e-6)


def grad_cam(model, img: torch.Tensor, img_wh, focal_boxes, focal_labels,
             match_iou_thr: float = 0.5) -> torch.Tensor:
    """grad-CAM of the detection score on the RoI feature map.

    Args:
        model: the port's ``AttnShiftDetector``.
        img: (1, H, W, 3) preprocessed image; img_wh: (1, 2) true (w, h).
        focal_boxes: (F, 4) boxes to explain; focal_labels: (F,).

    Returns:
        (Hp, Wp) f32 cam in [0, 1] on the feature grid, on the model's
        device; the heads differentiated in f32.
    """
    h, w = img.shape[1:3]
    with torch.no_grad():
        out, roi_map, _ = model._extract(img, with_features=True, capture=False)
    out = dict(out, feature=tuple(f.float() for f in out["feature"]))
    return grad_cam_from_feats(model, out, roi_map.float(), img_wh, (h, w), focal_boxes,
                               focal_labels, match_iou_thr)


def eigen_cam(activations: torch.Tensor) -> torch.Tensor:
    """EigenCAM: (C, H, W) activations projected on the first principal
    component of their centred (H*W, C) matrix, oriented to agree with the
    channel-mean energy map, relu'd and min-max scaled -> (H, W) in [0, 1].
    The direction is defined only where the first two singular values
    differ."""
    c, h, w = activations.shape
    acts = activations.float()
    x = acts.reshape(c, h * w).T  # (HW, C)
    x = x - x.mean(dim=0, keepdim=True)
    _, _, vt = torch.linalg.svd(x, full_matrices=False)
    proj = x @ vt[0]
    energy = acts.mean(dim=0).reshape(h * w)
    if float(torch.dot(proj, energy - energy.mean())) < 0:
        proj = -proj
    cam = proj.reshape(h, w).clamp_min(0.0)
    cam = cam - cam.min()
    return cam / cam.max().clamp_min(1e-6)


def featmap_am(activations: torch.Tensor) -> torch.Tensor:
    """FeatmapAM: the (C, H, W) activations' channel mean, min-max scaled
    -> (H, W) in [0, 1]."""
    cam = activations.float().mean(dim=0)
    cam = cam - cam.min()
    return cam / cam.max().clamp_min(1e-6)


def cam_on_image(img, cam, alpha: float = 0.5) -> np.ndarray:
    """Resize a feature-grid cam to the (H, W, 3) uint8 image and overlay it."""
    from PIL import Image

    img = _np(img)
    h, w = img.shape[:2]
    heat = np.asarray(
        Image.fromarray((_np(cam) * 255).astype(np.uint8)).resize((w, h), Image.BILINEAR),
        np.float32,
    ) / 255.0
    return overlay_heatmap(img, heat, alpha=alpha)
