"""Mean-field CRF refinement of attention maps, and the water fill.

Port of ``attentionshift_tpu/pseudo/crf.py``: per-instance attention
maps are the unaries of a dense CRF whose pairwise potential is the
patch features' cosine similarity (clipped at 0) times a spatial
Gaussian; a fixed number of mean-field iterations sharpens the maps.
``water_fill`` picks, per iteration, the feature whose thresholded
similarity row covers the most remaining attention mass, and drains the
mass it covers; its ``n_iter`` slots carry a validity mask in place of
the reference's early break.

Plain tensor code, as in the JAX package, which computes the (N, N)
affinity and the message products outside any kernel: here they are
``torch.matmul`` on whatever device the inputs are on.
"""

from __future__ import annotations

import torch

__all__ = ["feature_affinity", "mean_field_refine", "water_fill"]


def feature_affinity(feats: torch.Tensor, hw: tuple[int, int], sigma_factor: float = 0.5,
                     sim_bin_thr: float = 0.0) -> torch.Tensor:
    """(N, D) patch features -> (N, N) pairwise affinity: cosine similarity
    times a spatial Gaussian of width ``sigma_factor * sqrt(H*W)``, zero
    on the diagonal."""
    h, w = hw
    feats = feats.float()
    f = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    sim = f @ f.T
    if sim_bin_thr > 0:
        sim = torch.where(sim > sim_bin_thr, sim, 0.0)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=feats.device),
                            torch.arange(w, dtype=torch.float32, device=feats.device),
                            indexing="ij")
    coords = torch.stack([ys.reshape(-1), xs.reshape(-1)], dim=-1)
    d2 = ((coords[:, None] - coords[None]) ** 2).sum(-1)
    sigma = sigma_factor * torch.tensor(float(h * w), device=feats.device).sqrt()
    spatial = torch.exp(-d2 / (2.0 * sigma ** 2).clamp_min(1e-6))
    aff = sim.clamp_min(0.0) * spatial
    # zero the diagonal: a pixel should not message itself
    return aff * (1.0 - torch.eye(h * w, device=feats.device))


def mean_field_refine(attn_maps: torch.Tensor, feats: torch.Tensor, num_iter: int = 10,
                      sigma_factor: float = 0.5, unary_weight: float = 1.0,
                      pairwise_weight: float = 1.0) -> torch.Tensor:
    """(G, H, W) nonnegative maps and (H*W, D) features -> (G, H, W)
    refined probabilities (softmax over G + 1 slots, the appended
    background slot dropped)."""
    g, h, w = attn_maps.shape
    aff = feature_affinity(feats, (h, w), sigma_factor)
    msg_op = aff / aff.sum(-1, keepdim=True).clamp_min(1e-6)  # row-stochastic
    fg = attn_maps.float().reshape(g, -1)
    bg = (1.0 - fg.amax(0, keepdim=True)).clamp_min(0.0)
    unary = torch.log(torch.cat([fg, bg], dim=0) + 1e-6)  # (G+1, N)
    q = torch.softmax(unary, dim=0)
    for _ in range(num_iter):
        msg = q @ msg_op.T  # (G+1, N) neighbourhood consensus
        q = torch.softmax(unary_weight * unary + pairwise_weight * torch.log(msg + 1e-6), dim=0)
    return q[:g].reshape(g, h, w)


def water_fill(feats: torch.Tensor, sim_inter: torch.Tensor, attns_in: torch.Tensor,
               n_iter: int = 1, thr: float | None = None):
    """Greedy coverage-based prototype extraction.

    Args:
        feats: (N, D) patch features; sim_inter: (N, N) similarity;
        attns_in: (N,) nonnegative attention mass to cover.
        thr: absolute similarity threshold (``water_fill_adaptive``);
            None: the relative ``0.8 * row max`` (``water_fill``).

    Returns:
        prototypes (n_iter, D), valid (n_iter,) bool: slot 0 always valid,
        and once a slot is invalid every later one is (the reference's
        ``break``).
    """
    if thr is None:
        row_max = sim_inter.amax(dim=1, keepdim=True)
        sim = torch.where(sim_inter < row_max * 0.8, 0.0, sim_inter)
    else:
        sim = torch.where(sim_inter <= thr, 0.0, sim_inter)
    attn = attns_in.float()
    prots, oks = [], []
    for i in range(n_iter):
        s_in = sim @ attn  # (N,) coverage of the remaining mass
        idx = torch.argmax(s_in)
        oks.append((s_in[idx] > 0) | (i == 0))
        covered = (sim[idx] > 0).to(attn.dtype)
        attn = (attn - covered * (attn > 0)).clamp(0.0, 1.0)
        prots.append(feats[idx])
    valid = torch.cumprod(torch.stack(oks).to(torch.int32), dim=0) > 0
    return torch.stack(prots), valid
