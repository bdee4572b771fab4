"""Visualisation of pseudo labels / attention / detections.

The port's own copy of ``attentionshift_tpu/utils/visualize.py`` (which
imports no JAX; the port imports nothing of the JAX package): the
detector's pseudo-label dump, heat-map overlays and box/point/mask
drawings. Host-side numpy/PIL, no display; everything lands as pngs.
Every function also takes tensors, on any device: they are moved to
numpy first (``_np``).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image, ImageDraw

__all__ = ["denormalize", "draw_detections", "overlay_heatmap", "dump_pseudo_labels"]

_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
_STD = np.asarray([58.395, 57.12, 57.375], np.float32)

_COLORS = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 190), (0, 128, 128), (170, 110, 40),
]


def _np(x):
    """A tensor (any device, any dtype) or array-like -> numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        x = x.float() if x.is_floating_point() else x
        return x.numpy()
    return np.asarray(x)


def denormalize(img) -> np.ndarray:
    """(H, W, 3) normalised float -> uint8 RGB."""
    return np.clip(_np(img) * _STD + _MEAN, 0, 255).astype(np.uint8)


def overlay_heatmap(img, heat, alpha: float = 0.5) -> np.ndarray:
    """Blend a (H, W) map (auto-normalised, red channel) over the image."""
    img = _np(img)
    h = _np(heat).astype(np.float32)
    h = (h - h.min()) / max(h.max() - h.min(), 1e-6)
    if h.shape != img.shape[:2]:
        h = np.asarray(Image.fromarray((h * 255).astype(np.uint8)).resize(
            (img.shape[1], img.shape[0]))) / 255.0
    color = np.zeros_like(img, np.float32)
    color[..., 0] = h * 255
    color[..., 2] = (1 - h) * 128
    return np.clip(img * (1 - alpha * h[..., None]) + color * alpha * h[..., None],
                   0, 255).astype(np.uint8)


def draw_detections(img, boxes, labels=None, scores=None, points=None, masks=None,
                    class_names=None) -> np.ndarray:
    """Draw boxes/points/masks on a uint8 RGB image; returns a copy."""
    out = _np(img).copy()
    boxes = _np(boxes)
    labels, scores, points, masks = (None if a is None else _np(a)
                                     for a in (labels, scores, points, masks))
    if masks is not None:
        for i, m in enumerate(masks):
            color = np.asarray(_COLORS[i % len(_COLORS)], np.float32)
            out = np.where(
                m[..., None], (0.5 * out + 0.5 * color).astype(np.uint8), out
            )
    pil = Image.fromarray(out)
    d = ImageDraw.Draw(pil)
    for i, box in enumerate(np.asarray(boxes)):
        color = _COLORS[i % len(_COLORS)]
        d.rectangle([float(box[0]), float(box[1]), float(box[2]), float(box[3])],
                    outline=color, width=2)
        txt = ""
        if labels is not None:
            li = int(labels[i])
            txt = class_names[li] if class_names else str(li)
        if scores is not None:
            txt += f" {float(scores[i]):.2f}"
        if txt:
            d.text((float(box[0]) + 2, float(box[1]) + 2), txt, fill=color)
    if points is not None:
        for i, pt in enumerate(np.asarray(points)):
            color = _COLORS[i % len(_COLORS)]
            x, y = float(pt[0]), float(pt[1])
            d.ellipse([x - 3, y - 3, x + 3, y + 3], fill=color)
    return np.asarray(pil)


def dump_pseudo_labels(out_dir: str, name: str, img, aux: dict, class_names=None) -> list[str]:
    """Write the train-step ``aux`` dict (pseudo boxes/masks/centers/fg
    maps) as pngs — the `vis_imags/` dump analog. ``img`` is the
    normalised (H, W, 3) input; ``aux`` the detector's aux output for one
    image (leading batch dim already indexed away)."""
    os.makedirs(out_dir, exist_ok=True)
    base = denormalize(img)
    aux = {k: _np(v) for k, v in aux.items()}
    valid = np.asarray(aux["pseudo_valid"], bool)
    paths = []

    boxes = np.asarray(aux["pseudo_boxes"])[valid]
    centers = np.asarray(aux["semantic_centers"])[valid]
    cvalid = np.asarray(aux["semantic_valid"])[valid]
    masks = np.asarray(aux["pseudo_masks"])[valid].astype(bool)
    vis = draw_detections(
        base, boxes, masks=masks,
        points=centers[cvalid] if cvalid.any() else None,
        class_names=class_names,
    )
    p = os.path.join(out_dir, f"{name}_pseudo.png")
    Image.fromarray(vis).save(p)
    paths.append(p)

    fg = np.asarray(aux["map_fg"])[valid]
    if len(fg):
        p = os.path.join(out_dir, f"{name}_fg.png")
        Image.fromarray(overlay_heatmap(base, fg.max(0))).save(p)
        paths.append(p)
    return paths
