"""Cosine mean-shift part discovery (Stage C).

Port of ``attentionshift_tpu/pseudo/meanshift.py``: strided seed
prototypes on the eroded fg map, the mean-shift fixpoint over
box-masked features (``ops.meanshift_kernel``: the kernel on the card,
the plain ``cosine_shift_batch`` on the CPU), the fg-occupancy filter,
the greedy order-dependent cosine merge, and per-part centre extraction.
Padded instances and prototypes carry validity masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.image import resize
from ..ops.masks import box2mask, corrosion
from ..ops.meanshift_kernel import cosine_shift_batch, cosine_shift_fixpoint
from .points import strided_in_mask

__all__ = [
    "cosine_shift_batch",
    "mean_shift_grid_prototype",
    "filter_maps",
    "merge_maps",
    "get_center_coords",
    "semantic_centers",
    "SemanticCenters",
]


def mean_shift_grid_prototype(maps, vit_feat, rois, thr=0.35, n_shift=10, tau=0.1, temp=0.1,
                              n_points=20, matmul_dtype=None):
    """Seed + run the mean shift (`mean_shift_grid_prototype`).

    maps: (G, Hp, Wp) binary fg occupancy; vit_feat: (D, Hp, Wp);
    rois: (G, 4) full-res boxes. Returns prototypes (G, n_points, D) and
    sim (G, n_points, Hp, Wp) clamped at 0.
    """
    d, hp, wp = vit_feat.shape
    g = maps.shape[0]
    coords, n = strided_in_mask(maps >= thr, n_points)  # (G, K, 2) row/col
    # no eligible cell: the box centre on the patch grid
    r = rois.float()
    ctr = torch.stack([torch.floor((r[:, 1] + r[:, 3]) / 32.0),
                       torch.floor((r[:, 0] + r[:, 2]) / 32.0)], dim=-1).long()
    ctr = torch.minimum(ctr.clamp_min(0), torch.tensor([hp - 1, wp - 1], device=ctr.device))
    coords = torch.where((n > 0)[:, None, None], coords, ctr[:, None, :])
    prototypes = vit_feat[:, coords[..., 0], coords[..., 1]].permute(1, 2, 0)  # (G, K, D)
    box_mask = box2mask(torch.floor(r / 16.0), (hp, wp), default_val=0.0)
    f = vit_feat.reshape(d, -1).T
    prot, sim = cosine_shift_fixpoint(prototypes, box_mask.reshape(g, -1), f, tau=tau, temp=temp,
                                      n_shift=n_shift, matmul_dtype=matmul_dtype)
    return prot, sim.reshape(g, n_points, hp, wp).clamp_min(0.0)


def filter_maps(sim, pos_maps, pos_thr=0.85):
    """(G, K) validity: fg occupancy of each prototype's > 0.8 region."""
    fore = (sim > 0.8).float()
    score = (pos_maps[:, None] * fore).sum(dim=(-2, -1)) / fore.sum(dim=(-2, -1)).clamp_min(1e-6)
    return score >= pos_thr


def _cos_pairs(p: torch.Tensor) -> torch.Tensor:
    """(G, K, D) -> (G, K, K) cosine, eps 1e-8 on each norm."""
    num = torch.matmul(p, p.transpose(1, 2))
    n = p.norm(dim=-1).clamp_min(1e-8)
    return num / (n[:, :, None] * n[:, None, :])


def merge_maps(prot, valid, thr=0.85):
    """Greedy upper-triangular cosine merge (`merge_maps`), rows in index
    order: a row groups its >= thr partners, then absorbed rows drop out.
    Returns merged (G, K, D) and merged validity (G, K)."""
    g, k, d = prot.shape
    triu = torch.triu(torch.ones((k, k), dtype=torch.bool, device=prot.device))
    mat = (_cos_pairs(prot) >= thr) & triu & valid[:, :, None] & valid[:, None, :]
    out = torch.zeros_like(prot)
    out_v = torch.zeros((g, k), dtype=torch.bool, device=prot.device)
    for i in range(k):
        weight = mat[:, i].float()  # (G, K)
        s = weight.sum(-1)
        merged = torch.einsum("gk,gkd->gd", weight, prot) / (s + 1e-8)[:, None]
        has = s > 0
        out[:, i] = torch.where(has[:, None], merged, out[:, i])
        out_v[:, i] = has
        mat = torch.where((has[:, None] & (weight > 0))[:, :, None], False, mat)
    return out, out_v


def get_center_coords(sim, prot_valid, rois, vit_feat, max_parts):
    """Part centres (`get_center_coord_with_feat`): prototypes ordered by
    the area of their > 0.9 region (invalid last), the first ``max_parts``
    kept; a centre is the mean position of its map's maxima.

    Returns coords (G, P, 2) xy full-res, part_valid (G, P), feats (G, P, D).
    """
    g, k, hp, wp = sim.shape
    rows = torch.arange(hp, dtype=torch.float32, device=sim.device)[:, None]
    cols = torch.arange(wp, dtype=torch.float32, device=sim.device)[None, :]
    area = (sim > 0.9).sum(dim=(-2, -1))
    area = torch.where(prot_valid, area, -1)
    order = torch.argsort(-area, dim=1, stable=True)
    take = order[:, :max_parts]
    tv = torch.gather(prot_valid, 1, take)
    smap = torch.gather(sim, 1, take[:, :, None, None].expand(-1, -1, hp, wp))
    amax = smap >= smap.amax(dim=(-2, -1), keepdim=True)
    cnt = amax.sum(dim=(-2, -1)).clamp_min(1)
    mean_r = (amax * rows).sum(dim=(-2, -1)) / cnt
    mean_c = (amax * cols).sum(dim=(-2, -1)) / cnt
    x = (mean_c + 0.5) * 16.0
    y = (mean_r + 0.5) * 16.0
    r = rois.float()
    inside = (x >= r[:, 0:1]) & (x <= r[:, 2:3]) & (y >= r[:, 1:2]) & (y <= r[:, 3:4])
    fr = mean_r.long().clamp(0, hp - 1)
    fc = mean_c.long().clamp(0, wp - 1)
    feats = vit_feat[:, fr, fc].permute(1, 2, 0)  # (G, P, D)
    return torch.stack([x, y], dim=-1), tv & inside, feats


class SemanticCenters(NamedTuple):
    coords: torch.Tensor  # (G, P, 2) xy
    part_valid: torch.Tensor  # (G, P)
    feats: torch.Tensor  # (G, P, D)
    labels: torch.Tensor  # (G,)


def semantic_centers(map_fg, map_bg, rois, vit_feat, gt_labels, valid, pos_thr=0.35, n_shift=10,
                     merge_thr=0.85, num_semantic_points=3, num_prototypes=20, stride=1,
                     matmul_dtype=None) -> SemanticCenters:
    """Stage C (`get_semantic_centers`); ``map_fg``/``map_bg`` at
    image resolution / ``stride``, everything else at patch resolution.
    ``map_bg`` is taken for signature parity: the filter reads fg only."""
    d, hp, wp = vit_feat.shape
    g = map_fg.shape[0]
    corr = 11 if stride == 1 else max(1, (int(round(11 / stride)) // 2) * 2 + 1)
    fg_bin = torch.where(map_fg > pos_thr, 1.0, 0.0)
    fg_inter = resize(corrosion(fg_bin, corr), (hp, wp))
    map_fg_patch = torch.where(fg_inter > pos_thr, 1.0, 0.0)
    prot, sim = mean_shift_grid_prototype(map_fg_patch, vit_feat, rois, thr=pos_thr,
                                          n_shift=n_shift, n_points=num_prototypes,
                                          matmul_dtype=matmul_dtype)
    keep = filter_maps(sim, fg_inter) & valid[:, None]
    merged, merged_valid = merge_maps(prot, keep, thr=merge_thr)
    f = vit_feat.reshape(d, -1).float()
    fn = f / f.norm(dim=0, keepdim=True).clamp_min(1e-8)
    mn = merged / merged.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    if matmul_dtype not in (None, torch.float32):
        fn, mn = fn.to(matmul_dtype).float(), mn.to(matmul_dtype).float()
    sim_merged = torch.matmul(mn, fn).reshape(g, -1, hp, wp)
    coords, part_valid, feats = get_center_coords(sim_merged, merged_valid, rois, vit_feat,
                                                  num_semantic_points + 1)
    return SemanticCenters(coords, part_valid & valid[:, None], feats, gt_labels)
