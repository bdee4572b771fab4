"""Iterative cosine-similarity refinement of fg/bg maps (Stage B).

Port of ``attentionshift_tpu/pseudo/refine.py`` (the functions on the
pseudo-label path): point-prototype cosine maps, the threshold ->
masked-mean prototype -> cosine refinement loop with winner-take-all
selection, the fg/bg seed-point sampler and the mask supervision point
sampler. ``vit_feat`` is (D, Hp, Wp) patch features; boxes, points and
returned coordinates are in full-resolution pixels.

The samplers take a ``torch.Generator`` or their draws as tensors:
``sample_fgbg_points`` via ``points_override`` of
``cosine_similarity_refined_map``, ``sample_mask_points`` via ``gumbel``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.image import resize
from ..ops.masks import box2mask, corrosion
from .cam import norm_attns
from .points import sample_in_mask, strided_in_mask, topk_in_mask

__all__ = [
    "RefinedMaps",
    "cosine_similarity_refined_map",
    "sample_fgbg_points",
    "sample_mask_points",
]


def normalize_map(m: torch.Tensor) -> torch.Tensor:
    return m / (m.amax(dim=(-2, -1), keepdim=True) + 1e-8)


def decouple_instance(map_bg: torch.Tensor, map_fg: torch.Tensor) -> torch.Tensor:
    bg = normalize_map(map_bg)
    fg = normalize_map(map_fg)
    return bg + (1.0 - (fg * 0.5 + bg * 0.5))


def _cos_map(vit_feat: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    """(D, Hp, Wp) features, (M, D) prototypes -> (M, Hp, Wp) cosine."""
    d, hp, wp = vit_feat.shape
    f = vit_feat.reshape(d, -1)
    fn = f / f.norm(dim=0, keepdim=True).clamp_min(1e-8)
    pn = proto / proto.norm(dim=1, keepdim=True).clamp_min(1e-8)
    return torch.matmul(pn, fn).reshape(-1, hp, wp)


def point_prototype_sim(points_xy: torch.Tensor, vit_feat: torch.Tensor) -> torch.Tensor:
    """Mean-of-point-features prototype per row of (M, K, 2) xy -> cosine map."""
    d, hp, wp = vit_feat.shape
    col = (points_xy[..., 0].long() // 16).clamp(0, wp - 1)
    row = (points_xy[..., 1].long() // 16).clamp(0, hp - 1)
    feats = vit_feat[:, row, col]  # (D, M, K)
    return _cos_map(vit_feat, feats.mean(dim=-1).T)


def refined_similarity(points_xy, vit_feat, boxes, num_box_maps, refine_times=2, tau=0.85,
                       is_select=False, valid=None):
    """Iterative prototype refinement (`get_refined_similarity`).

    Returns the final (M, Hp, Wp) map (winner-take-all selected when
    ``is_select``) and the (M, D) prototypes.
    """
    d, hp, wp = vit_feat.shape
    cos = point_prototype_sim(points_xy, vit_feat)
    m = cos.shape[0]
    bbox_mask = box2mask(torch.floor(boxes / 16.0), (hp, wp), default_val=0.0)
    f = vit_feat.reshape(d, -1)
    ar = torch.arange(m, device=cos.device)[:, None, None]

    def select(cmap):
        body = torch.cat([cmap[:num_box_maps] * bbox_mask, cmap[num_box_maps:]], dim=0)
        cand = body if valid is None else torch.where(valid[:, None, None], body, -1.0)
        keep = torch.argmax(cand, dim=0)[None] == ar
        return body, torch.where(keep, body, 0.0)

    proto = None
    selected = cos
    for _ in range(refine_times):
        thr = cos.amax(dim=(-2, -1), keepdim=True) * tau
        cosm = torch.where(cos < thr, 0.0, cos).reshape(m, -1)
        wsum = cosm.sum(-1, keepdim=True).clamp_min(1e-8)
        proto = torch.matmul(cosm, f.T) / wsum
        cos = _cos_map(vit_feat, proto)
        if is_select:
            cos, selected = select(cos)
        else:
            selected = cos
    if proto is None:
        proto = torch.zeros((m, d), device=cos.device)
        selected = select(cos)[1] if is_select else cos
    return selected, proto


def sample_fgbg_points(attn_norm, gt_points, thr_pos=0.2, thr_neg=0.1, num_points=20,
                       stride=1, generator=None):
    """Seed points (`sample_point_grid` semantics).

    attn_norm: (G, H/stride, W/stride) normalised best-layer CAMs;
    gt_points: (G, 2) full-res xy. Returns points_fg (G+1, num_points, 2)
    (last row: bg support from the mean map) and points_bg
    (G, num_points, 2), xy in full-res pixels.
    """
    g = attn_norm.shape[0]
    off = stride // 2

    # fg: uniform draws when the mask has >= num_points pixels, else the
    # raster-order pixels then the annotated point
    mask = attn_norm >= thr_pos
    rand_rc, n = sample_in_mask(mask, num_points, generator)
    raster_rc, _ = strided_in_mask(mask, num_points)
    gt_rc = torch.stack([gt_points[:, 1], gt_points[:, 0]], dim=-1)
    gt_cell = ((gt_rc - off) / stride).long()[:, None, :]
    slot = torch.arange(num_points, device=mask.device)[None, :, None]
    few = torch.where(slot < n[:, None, None], raster_rc, gt_cell)
    fg = torch.where((n >= num_points)[:, None, None], rand_rc, few) * stride + off

    # bg: threshold doubling until enough eligible pixels (`:360-364`)
    def bg(maps):
        coords = torch.zeros((maps.shape[0], num_points, 2), dtype=torch.long, device=maps.device)
        got = torch.zeros(maps.shape[0], dtype=torch.bool, device=maps.device)
        for lvl in range(4):
            c, nn_ = sample_in_mask(maps < thr_neg * (2.0**lvl), num_points, generator)
            take = ~got & (nn_ >= num_points)
            coords = torch.where(take[:, None, None], c, coords)
            got = got | (nn_ >= num_points)
        return coords * stride + off

    points_bg = bg(attn_norm)
    supp = bg(attn_norm.mean(0, keepdim=True))
    points_fg = torch.cat([fg, supp], dim=0)
    return points_fg.flip(-1).float(), points_bg.flip(-1).float()


class RefinedMaps(NamedTuple):
    map_fg: torch.Tensor  # (G, H, W) final fg map, max-normalised
    map_bg: torch.Tensor  # (G, H, W) decoupled bg map, max-normalised
    fg_proto: torch.Tensor  # (G+1, D)
    bg_proto: torch.Tensor  # (G, D)
    points_fg: torch.Tensor
    points_bg: torch.Tensor
    fg_patch: torch.Tensor  # (G, Hp, Wp) final patch-res fields, pre-resize
    bg_patch: torch.Tensor


def cosine_similarity_refined_map(cams, vit_feat, boxes, gt_points, valid, thr_pos=0.2,
                                  thr_neg=0.1, num_points=20, refine_times=2, obj_tau=0.85,
                                  points_override=None, stride=1, generator=None) -> RefinedMaps:
    """Full Stage-B map construction at H/stride x W/stride.

    ``points_override``: (points_fg (G+1, K, 2), points_bg (G, K, 2))
    replacing the random seed sampling.
    """
    g, h, w = cams.shape
    attn_norm = norm_attns(cams)
    if points_override is not None:
        points_fg, points_bg = (p.to(cams.device).float() for p in points_override)
    else:
        points_fg, points_bg = sample_fgbg_points(attn_norm, gt_points, thr_pos, thr_neg,
                                                  num_points, stride, generator)
    valid_fg = torch.cat([valid.bool(), torch.ones(1, dtype=torch.bool, device=valid.device)])
    cos_fg, fg_proto = refined_similarity(points_fg, vit_feat, boxes, g, refine_times, obj_tau,
                                          is_select=True, valid=valid_fg)
    cos_bg, bg_proto = refined_similarity(points_bg, vit_feat, boxes, g, refine_times, obj_tau,
                                          is_select=False)
    fg_patch, bg_patch = cos_fg[:g], cos_bg
    cos_fg = resize(cos_fg, (h, w))[:g]
    cos_bg = resize(cos_bg, (h, w))
    ret = (1.0 - cos_bg) * cos_fg
    val = ret.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-8)
    bg_dec = decouple_instance(cos_bg, ret)
    bg_val = bg_dec.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-8)
    return RefinedMaps(ret / val, bg_dec / bg_val, fg_proto, bg_proto, points_fg, points_bg,
                       fg_patch, bg_patch)


def sample_mask_points(map_fg, map_bg, boxes, num_gt=10, pos_thr=0.6, neg_thr=0.6, corr_size=21,
                       stride=1, generator=None, gumbel=None):
    """Mask supervision points inside each pseudo box
    (`get_mask_points_single_box_cos_map_fg_bg`).

    ``gumbel``: optional (G, H/stride * W/stride) noise of the draw.
    Returns coords (G, num_gt, 2) xy full-res (-1 when the box has no
    eligible pixel) and labels (G, num_gt) bool (True = positive).
    """
    g, h, w = map_fg.shape
    dev = map_fg.device
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    if stride > 1:
        corr_size = max(1, (int(round(corr_size / stride)) // 2) * 2 + 1)
    b = (boxes.float() / stride).long()  # truncation toward zero, as astype(int32)
    x1, y1, x2, y2 = (b[:, i, None, None] for i in range(4))
    inside = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    crop_max_fg = torch.where(inside, map_fg, -torch.inf).amax(dim=(-2, -1), keepdim=True)
    crop_max_bg = torch.where(inside, map_bg, -torch.inf).amax(dim=(-2, -1), keepdim=True)
    pos_bin = (map_fg > crop_max_fg * pos_thr) & inside
    pos_ero = corrosion(torch.where(inside, pos_bin.float(), 1.0), corr_size)
    pos_elig = (pos_ero > 0.0) & inside
    neg_elig = (map_bg > crop_max_bg * neg_thr) & inside
    union = pos_elig | neg_elig
    coords, _, n = topk_in_mask(union, num_gt, generator, gumbel)
    labels = pos_elig.reshape(g, -1).gather(1, coords[..., 0] * w + coords[..., 1])
    xy = (coords.flip(-1) * stride + stride // 2).float()
    empty = (n == 0)[:, None]
    xy = torch.where(empty[..., None], -1.0, xy)
    labels = torch.where(empty, False, labels)
    return xy, labels
