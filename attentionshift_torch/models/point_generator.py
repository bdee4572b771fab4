"""Class-agnostic supervision-point generator (RepPoints auxiliary).

Port of ``attentionshift_tpu/models/point_generator.py``: part anchors
sample a dense contour-offset field, each part's predicted contour is
rasterised as a filled convex hull, per-object hull sums are normalised
and thresholded into core regions, and a part is kept when its hull
covers enough of its object's core. The parts lie on one padded axis
with an owner index and a validity mask.

The hull is the JAX package's fixed-step Jarvis march and half-plane
rasteriser, for all P parts at once, evaluated on a grid of stride
``raster_stride``. Its start vertex is
``argmin(x * 1e6 + y)`` in f32, as in JAX: at image-scale x the y term
falls below the f32 spacing, and ties go to the first index. Plain
tensor code: no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.sampling import point_sample

__all__ = ["SupervisionPointGenerator", "convex_hull_mask", "SupervisionPoints"]


def _cross(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def hull_vertices(pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K, 2) points -> the (..., K + 1, 2) closed Jarvis walk (the
    start vertex first; after the hull closes the walk re-emits its last
    vertex, and the zero-length edges are neutral in the half-plane test)
    and the (...,) scale-relative tolerance eps of the march."""
    lead, k = pts.shape[:-2], pts.shape[-2]
    p = pts.reshape(-1, k, 2).float()
    n = p.shape[0]
    lo, hi = p.amin(1), p.amax(1)
    # cross products are O(extent^2) and f32 rounding ~1e-7 relative
    extent = (hi - lo).amax(-1).clamp_min(1.0)
    eps = 1e-5 * extent * extent + 1e-6  # (n,)
    start = torch.argmin(p[..., 0] * 1e6 + p[..., 1], dim=1)
    rows = torch.arange(n, device=p.device)
    cur = start
    order = []
    for _ in range(k):
        c = p[rows, cur]  # (n, 2)
        cr = _cross(c[:, None, None], p[:, :, None], p[:, None, :])  # (n, q, p)
        ok = (cr <= eps[:, None, None]).all(dim=2)  # all points clockwise of c->q
        d = (p - c[:, None]).norm(dim=-1)
        score = torch.where(ok, d, -1.0)
        nxt = torch.argmax(score, dim=1)
        cur = torch.where(score[rows, nxt] <= 0.0, cur, nxt)  # duplicates/degenerate
        order.append(cur)
    verts = torch.cat([p[rows, start][:, None], p[rows[:, None], torch.stack(order, 1)]], dim=1)
    return verts.reshape(*lead, k + 1, 2), eps.reshape(lead)


def convex_hull_mask(pts: torch.Tensor, grid_hw: tuple[int, int],
                     stride: float = 1.0) -> torch.Tensor:
    """Rasterise the filled convex hull of (..., K, 2) xy points on an (H, W)
    grid -> (..., H, W) bool; pixel (r, c) samples ((c + 0.5) * stride,
    (r + 0.5) * stride). A collinear set is the point box intersected with
    the collinear band."""
    h, w = grid_hw
    lead = pts.shape[:-2]
    verts, eps = hull_vertices(pts)
    verts = verts.reshape(-1, verts.shape[-2], 2)
    eps = eps.reshape(-1)
    p = pts.reshape(-1, pts.shape[-2], 2).float()
    lo, hi = p.amin(1), p.amax(1)  # (n, 2)
    ys = (torch.arange(h, dtype=torch.float32, device=p.device) + 0.5) * stride
    xs = (torch.arange(w, dtype=torch.float32, device=p.device) + 0.5) * stride
    grid = torch.stack(torch.broadcast_tensors(xs[None, :], ys[:, None]), dim=-1)  # (H, W, 2)
    inside = torch.ones((verts.shape[0], h, w), dtype=torch.bool, device=p.device)
    for e in range(verts.shape[1] - 1):
        a, b = verts[:, e, None, None], verts[:, e + 1, None, None]
        inside &= _cross(a, b, grid[None]) <= eps[:, None, None]
    gx, gy = grid[None, ..., 0], grid[None, ..., 1]
    inbox = ((gx >= (lo[:, 0] - stride)[:, None, None]) & (gx <= (hi[:, 0] + stride)[:, None, None])
             & (gy >= (lo[:, 1] - stride)[:, None, None]) & (gy <= (hi[:, 1] + stride)[:, None, None]))
    return (inside & inbox).reshape(*lead, h, w)


class SupervisionPoints(NamedTuple):
    scores: torch.Tensor  # (P,) core-coverage score per part
    keep: torch.Tensor  # (P,) bool
    core_regions: torch.Tensor  # (O, Hs, Ws) bool
    pred_points: torch.Tensor  # (P, K, 2) sampled contour points


class SupervisionPointGenerator:
    """Fixed-shape supervision-point filter over a part axis.

    Args:
        point_strides: stride of the offset field (reference: 16).
        mask_thr: core-region threshold on the normalised hull sum.
        point_thr: keep threshold on the core-coverage score.
        raster_stride: hull rasterisation stride in pixels.
    """

    def __init__(self, point_strides: int = 16, mask_thr: float = 0.75,
                 point_thr: float = 0.75, raster_stride: int = 4):
        self.point_strides = point_strides
        self.mask_thr = mask_thr
        self.point_thr = point_thr
        self.raster_stride = raster_stride

    def pred_points(self, anchors: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        """(P, 2) xy anchors and a (2K, Hf, Wf) offset field -> (P, K, 2)
        contour points (anchor + sampled offset x stride)."""
        _, hf, wf = offsets.shape
        h, w = hf * self.point_strides, wf * self.point_strides
        norm = anchors.float() / torch.tensor([w, h], dtype=torch.float32, device=anchors.device)
        samp = point_sample(offsets[None].float(), norm[None])[0]  # (2K, P)
        off = samp.reshape(-1, 2, anchors.shape[0]).permute(2, 0, 1)
        return off * self.point_strides + anchors[:, None, :].float()

    def __call__(self, ctr_offsets: torch.Tensor, init_pts: torch.Tensor, part_obj: torch.Tensor,
                 part_valid: torch.Tensor, num_objects: int) -> SupervisionPoints:
        """Generate and filter supervision points.

        Args:
            ctr_offsets: (2K, Hf, Wf) contour-offset field.
            init_pts: (P, 2) part anchors (semantic centres + gt points).
            part_obj: (P,) owning object slot; part_valid: (P,) bool.
            num_objects: O.
        """
        _, hf, wf = ctr_offsets.shape
        hs = hf * self.point_strides // self.raster_stride
        ws = wf * self.point_strides // self.raster_stride
        pred = self.pred_points(init_pts, ctr_offsets)  # (P, K, 2)
        hulls = convex_hull_mask(pred, (hs, ws), float(self.raster_stride))
        hulls = hulls & part_valid[:, None, None]
        owner = F.one_hot(part_obj.long(), num_objects).T.float() * part_valid[None, :]  # (O, P)
        sums = torch.einsum("op,phw->ohw", owner, hulls.float())
        mx = sums.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-6)
        core = (sums / mx) > self.mask_thr  # (O, Hs, Ws)
        core_per_part = core[part_obj.long()]  # (P, Hs, Ws)
        denom = core_per_part.sum(dim=(-2, -1)).float().clamp_min(1e-4)
        scores = (hulls & core_per_part).sum(dim=(-2, -1)).float() / denom
        keep = (scores > self.point_thr) & part_valid
        return SupervisionPoints(scores, keep, core, pred)
