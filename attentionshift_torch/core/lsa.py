"""Linear sum assignment (Hungarian algorithm with potentials).

Port of ``attentionshift_tpu/core/lsa.py``: the same e-maxx shortest
augmenting path algorithm with zero initial potentials, in float32, with
the same tie-breaking (the first minimum column wins), so it returns the
JAX package's assignment, which is scipy's whenever the optimum is
unique.

The cost matrix is tiny (max_gt x point tokens), so the solver runs on
the host: one device-to-host copy of the costs and one host-to-device
copy of the result per call, the only host synchronisation of the
pseudo-label path besides the plain CCL loop.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["linear_sum_assignment"]

_INF = np.float32(1e30)


def _solve(cost: np.ndarray, row_valid: np.ndarray) -> np.ndarray:
    n, m = cost.shape
    u = np.zeros(n, np.float32)
    v = np.zeros(m, np.float32)
    p = np.full(m, -1, np.int64)  # row matched to each column
    for i in range(n):
        if not row_valid[i]:
            continue
        minv = np.full(m, _INF, np.float32)
        used = np.zeros(m, bool)
        way = np.full(m, -1, np.int64)
        i0, j0 = i, -1
        while True:
            cur = cost[i0] - u[i0] - v
            better = (~used) & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            j1 = int(np.argmin(np.where(used, _INF, minv)))
            delta = np.float32(0.0) if used[j1] else minv[j1]
            on_path = np.zeros(n, bool)
            on_path[p[used & (p >= 0)]] = True
            on_path[i] = True
            u = np.where(on_path, u + delta, u).astype(np.float32)
            v = np.where(used, v - delta, v).astype(np.float32)
            minv = np.where(used, minv, minv - delta).astype(np.float32)
            used[j1] = True
            j0 = j1
            if p[j1] < 0:
                break
            i0 = int(p[j1])
        # augment along way[] back from the free column
        while j0 >= 0:
            j1 = int(way[j0])
            p[j0] = i if j1 < 0 else p[j1]
            j0 = j1
    col_for_row = np.full(n, -1, np.int64)
    for j in range(m):
        if p[j] >= 0:
            col_for_row[p[j]] = max(col_for_row[p[j]], j)
    return col_for_row


def linear_sum_assignment(cost: torch.Tensor, row_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Minimum-cost assignment of the (n, m) cost rows to columns, n <= m.

    Rows with ``row_valid`` False are skipped and get -1. Returns (n,)
    int32 column per row on the cost's device.
    """
    c = cost.detach().float().cpu().numpy()
    rv = (np.ones(c.shape[0], bool) if row_valid is None
          else row_valid.detach().cpu().numpy().astype(bool))
    return torch.from_numpy(_solve(c, rv).astype(np.int32)).to(cost.device)
