"""RoIAlign with mmcv semantics as separable interpolation matmuls.

Port of ``attentionshift_tpu/ops/roi_align.py``: each RoI builds row and
column bilinear weight matrices (zero outside [-1, size], clamped at the
border), the crop is ``Wy @ F @ Wx^T``, then an average over the fixed
``sampling_ratio`` x ``sampling_ratio`` samples of each bin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["roi_align"]


def _interp_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """(N, S) continuous pixel coords -> (N, S, size) bilinear weights."""
    valid = ((coords > -1.0) & (coords < size)).float()
    c = coords.clamp(0.0, size - 1.0)
    lo = torch.floor(c)
    frac = c - lo
    lo_i = lo.long()
    hi_i = (lo_i + 1).clamp_max(size - 1)
    return (F.one_hot(lo_i, size).float() * ((1.0 - frac) * valid)[..., None]
            + F.one_hot(hi_i, size).float() * (frac * valid)[..., None])


def roi_align(feats: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    """feats (B, C, H, W), rois (N, 5) [batch_idx, x1, y1, x2, y2] ->
    (N, C, output_size, output_size) in feats' dtype."""
    b, c, h, w = feats.shape
    n = rois.shape[0]
    out, sr = output_size, sampling_ratio
    offset = 0.5 if aligned else 0.0
    r = rois.float()
    x1 = r[:, 1] * spatial_scale - offset
    y1 = r[:, 2] * spatial_scale - offset
    roi_w = r[:, 3] * spatial_scale - offset - x1
    roi_h = r[:, 4] * spatial_scale - offset - y1
    if not aligned:
        roi_w = roi_w.clamp_min(1.0)
        roi_h = roi_h.clamp_min(1.0)
    bin_w, bin_h = roi_w / out, roi_h / out
    bins = torch.arange(out, dtype=torch.float32, device=feats.device)
    samp = torch.arange(sr, dtype=torch.float32, device=feats.device)
    rel = (bins[:, None] + (samp[None, :] + 0.5) / sr).reshape(-1)  # (out*sr,)
    ys = y1[:, None] + rel[None, :] * bin_h[:, None]
    xs = x1[:, None] + rel[None, :] * bin_w[:, None]
    wy = _interp_matrix(ys, h)  # (N, S, H)
    wx = _interp_matrix(xs, w)  # (N, S, W)
    if b == 1:
        crops = _crop(feats[0], wy, wx)
    else:
        # one image at a time: the intermediate is O(N_i C S W) per image,
        # never a copy of the whole map per RoI
        img = r[:, 0].long()
        crops = wy.new_zeros(n, c, out * sr, out * sr)
        for i in range(b):
            sel = (img == i).nonzero()[:, 0]
            if sel.numel():
                crops = crops.index_put((sel,), _crop(feats[i], wy[sel], wx[sel]))
    crops = crops.reshape(n, c, out, sr, out, sr).mean(dim=(3, 5))
    return crops.to(feats.dtype)


def _crop(feat, wy, wx):
    """(C, H, W) map, (N, S, H) and (N, T, W) weights -> (N, C, S, T),
    f32 accumulation."""
    tmp = torch.einsum("nsh,chw->ncsw", wy, feat.float())
    return torch.einsum("ncsw,ntw->ncst", tmp, wx)
