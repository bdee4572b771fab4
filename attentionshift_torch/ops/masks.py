"""Mask-map utilities: box rasterisation, morphology, mask pasting.

Port of ``attentionshift_tpu/ops/masks.py``: ``box2mask``, ``corrosion``
(min-pool erosion), ``expansion`` (max-pool dilation) and
``paste_masks``, the RoI -> image paste of the test path as a
fixed-shape bilinear gather.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["box2mask", "corrosion", "expansion", "paste_masks"]


def box2mask(bboxes: torch.Tensor, img_size: tuple[int, int], default_val: float = 0.5) -> torch.Tensor:
    """Rasterise (N, 4) xyxy boxes into (N, H, W): 1.0 inside (integer
    crop ``[int(y1):int(y2+1), int(x1):int(x2+1)]``), ``default_val``
    outside."""
    h, w = img_size
    ys = torch.arange(h, dtype=torch.float32, device=bboxes.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=bboxes.device)[None, None, :]
    b = torch.floor(bboxes.float())
    x1, y1, x2, y2 = (b[:, i, None, None] for i in range(4))
    inside = (xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)
    return torch.where(inside, 1.0, float(default_val))


def expansion(cam: torch.Tensor, expn_size: int = 5) -> torch.Tensor:
    """Max-pool dilation with SAME padding over the last two axes
    (out-of-range cells ignored), as two 1-D passes."""
    lead = cam.shape[:-2]
    x = cam.reshape(-1, 1, *cam.shape[-2:])
    pad = expn_size // 2
    x = F.max_pool2d(x, (expn_size, 1), stride=1, padding=(pad, 0))
    x = F.max_pool2d(x, (1, expn_size), stride=1, padding=(0, pad))
    return x.reshape(*lead, *cam.shape[-2:])


def corrosion(cam: torch.Tensor, corr_size: int = 11) -> torch.Tensor:
    """Min-pool erosion with SAME padding over the last two axes
    (``-F.max_pool2d(-cam, k, 1, k // 2)``; out-of-range cells ignored)."""
    return -expansion(-cam, corr_size)


def _bilinear_taps(coord: torch.Tensor, size: int):
    """Source indices and weights of 1-D bilinear sampling with zero
    padding: (i0, i1, w0, w1), out-of-range taps carrying weight 0."""
    i0f = torch.floor(coord)
    frac = coord - i0f
    i0 = i0f.long()
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < size), 1.0 - frac, 0.0)
    w1 = torch.where((i1 >= 0) & (i1 < size), frac, 0.0)
    return i0.clamp(0, size - 1), i1.clamp(0, size - 1), w0, w1


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, img_h: int, img_w: int) -> torch.Tensor:
    """Paste (N, h, w) RoI mask probabilities into (N, img_h, img_w).

    Bilinear grid-sample with ``align_corners=False`` and zero padding
    (detectron2's ``_do_paste_mask``) on fixed shapes: rows are mixed
    first, then columns; a degenerate box has its side floored at 1e-6.
    """
    n, mh, mw = masks.shape
    x1, y1, x2, y2 = (boxes[:, i:i + 1].float() for i in range(4))  # (N, 1) each
    img_y = torch.arange(img_h, dtype=torch.float32, device=masks.device)[None, :] + 0.5
    img_x = torch.arange(img_w, dtype=torch.float32, device=masks.device)[None, :] + 0.5
    # normalised [-1, 1] coords wrt each box, then source pixel coords
    gy = (img_y - y1) / (y2 - y1).clamp_min(1e-6) * 2.0 - 1.0  # (N, H)
    gx = (img_x - x1) / (x2 - x1).clamp_min(1e-6) * 2.0 - 1.0  # (N, W)
    sy = ((gy + 1.0) * mh - 1.0) / 2.0
    sx = ((gx + 1.0) * mw - 1.0) / 2.0
    y0, y1i, wy0, wy1 = _bilinear_taps(sy, mh)
    x0, x1i, wx0, wx1 = _bilinear_taps(sx, mw)
    rows0 = torch.gather(masks, 1, y0[:, :, None].expand(n, img_h, mw))
    rows1 = torch.gather(masks, 1, y1i[:, :, None].expand(n, img_h, mw))
    rowmix = rows0 * wy0[:, :, None] + rows1 * wy1[:, :, None]  # (N, H, w)
    cols0 = torch.gather(rowmix, 2, x0[:, None, :].expand(n, img_h, img_w))
    cols1 = torch.gather(rowmix, 2, x1i[:, None, :].expand(n, img_h, img_w))
    return cols0 * wx0[:, None, :] + cols1 * wx1[:, None, :]
