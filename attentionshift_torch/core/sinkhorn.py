"""Sinkhorn optimal transport and the semantic correspondence solver.

Port of ``attentionshift_tpu/core/sinkhorn.py``: the log-domain Sinkhorn
fixed point for a fixed number of iterations, a cosine-cost
part-to-part correspondence on top of it, and the regularised Hough
matching between two feature grids (a Chebyshev band of initial
hypotheses, then rounds of a joint 3x3 neighbourhood average over the
4-D (source, target) grid with row normalisation). Plain tensor code on
the device of its inputs: no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["sinkhorn", "semantic_correspondence", "hough_matching"]


def sinkhorn(cost: torch.Tensor, mu=None, nu=None, epsilon: float = 0.05,
             num_iter: int = 50) -> torch.Tensor:
    """Entropic-OT transport plan (N, M) for a (N, M) cost matrix, with
    row sums ~mu and column sums ~nu (uniform by default)."""
    n, m = cost.shape
    if mu is None:
        mu = torch.full((n,), 1.0 / n, device=cost.device)
    if nu is None:
        nu = torch.full((m,), 1.0 / m, device=cost.device)
    log_mu = torch.log(mu.clamp_min(1e-12))
    log_nu = torch.log(nu.clamp_min(1e-12))
    k = -cost / epsilon
    f = torch.zeros((n,), device=cost.device, dtype=k.dtype)
    g = torch.zeros((m,), device=cost.device, dtype=k.dtype)
    for _ in range(num_iter):
        f = log_mu - torch.logsumexp(k + g[None, :], dim=1)
        g = log_nu - torch.logsumexp(k + f[:, None], dim=0)
    return torch.exp(k + f[:, None] + g[None, :])


def semantic_correspondence(feats_a: torch.Tensor, feats_b: torch.Tensor, valid_a=None,
                            valid_b=None, epsilon: float = 0.05, num_iter: int = 50):
    """(plan (N, M), match (N,) int32): cosine-distance cost, Sinkhorn
    plan, best column per row. Invalid rows and columns cost 1e3 and get
    no marginal mass."""
    na = feats_a / torch.linalg.norm(feats_a, dim=-1, keepdim=True).clamp_min(1e-6)
    nb = feats_b / torch.linalg.norm(feats_b, dim=-1, keepdim=True).clamp_min(1e-6)
    cost = 1.0 - na @ nb.T
    mu = nu = None
    if valid_a is not None:
        cost = torch.where(valid_a[:, None], cost, 1e3)
        mu = valid_a.float() / valid_a.sum().clamp_min(1)
    if valid_b is not None:
        cost = torch.where(valid_b[None, :], cost, 1e3)
        nu = valid_b.float() / valid_b.sum().clamp_min(1)
    plan = sinkhorn(cost, mu, nu, epsilon, num_iter)
    return plan, plan.argmax(dim=1).int()


def _neighbor_shift_sum(t: torch.Tensor) -> torch.Tensor:
    """``out[y0,x0,y1,x1] = sum_{dy,dx in {-1,0,1}} t[y0-dy,x0-dx,y1-dy,x1-dx]``
    of a (H0, W0, H1, W1) tensor, out-of-range terms zero: the source and
    target grids shift together."""
    h0, w0, h1, w1 = t.shape
    tp = F.pad(t, (1, 1, 1, 1, 1, 1, 1, 1))
    out = torch.zeros_like(t)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + tp[1 - dy:1 - dy + h0, 1 - dx:1 - dx + w0,
                           1 - dy:1 - dy + h1, 1 - dx:1 - dx + w1]
    return out


def hough_matching(f0: torch.Tensor, f1: torch.Tensor, num_iter: int = 1,
                   num_smooth_iter: int = 3, dist_kernel: int = 5):
    """Regularised Hough matching between two (H, W, D) feature grids of
    one shape: (Cu, C), the raw cosine similarity (H*W, H*W) and the
    Hough-regularised correspondence (rows = source positions)."""
    h, w, _ = f0.shape
    n = h * w
    a = f0.reshape(n, -1)
    b = f1.reshape(n, -1)
    a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-4)
    b = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-4)
    cu = a @ b.T  # (N, N)
    # 1 where the Chebyshev distance of grid positions i, j is <= dist_kernel // 2
    yy, xx = torch.meshgrid(torch.arange(h, device=f0.device), torch.arange(w, device=f0.device),
                            indexing="ij")
    yy, xx = yy.reshape(n), xx.reshape(n)
    cheb = torch.maximum((yy[:, None] - yy[None, :]).abs(), (xx[:, None] - xx[None, :]).abs())
    dist_mask = (cheb <= dist_kernel // 2).to(cu.dtype)
    count = _neighbor_shift_sum(torch.ones((h, w, h, w), dtype=cu.dtype, device=cu.device))
    c = cu * dist_mask
    for _ in range(num_iter):
        votes = c
        for _ in range(num_smooth_iter):
            votes = (_neighbor_shift_sum(votes.reshape(h, w, h, w)) / count).reshape(n, n)
            votes = votes / (votes.sum(dim=1, keepdim=True) + 1e-4)
        c = cu + votes
        c = c / (c.sum(dim=1, keepdim=True) + 1e-4)
    return cu, c
