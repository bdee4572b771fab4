"""Fixed-shape exact greedy NMS.

Port of ``attentionshift_tpu/ops/nms.py``: up to ``max_out`` kept boxes
as padded indices plus a validity mask; precedence is higher score
first, first index on ties; level/class-aware behaviour through the
coordinate-offset trick. Greedy NMS is computed as the fixpoint of
"kept = alive and not suppressed by a kept box of higher precedence",
on boxes sorted by precedence, in row blocks so that no (N, N) matrix is
held at once (N = 8819 at the 800x1344 train shape).

As in the JAX twin, the fixpoint is a ``while_loop`` bounded by N
iterations (``torch._higher_order_ops.while_loop``: one operator of an
exported graph), and the outputs have a fixed size: the stable top-k of
the kept boxes' scores. Run eagerly, the loop still reads its predicate
on the host once per iteration (inside the ``nms.while_loop`` profiler
range).
"""

from __future__ import annotations

import torch
from torch._higher_order_ops.while_loop import while_loop_op

from .topk import top_k_stable

__all__ = ["nms", "batched_nms", "box_iou"]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (N, 4) x (M, 4) -> (N, M)."""
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-10)


@torch.no_grad()
def nms(boxes, scores, iou_threshold: float, max_out: int, valid=None, block: int = 1024):
    """Greedy NMS.

    Returns ``keep_idx`` (max_out,) int32 indices into the input (0 for
    padding) in selection order, and ``keep_valid`` (max_out,) bool.
    """
    n = boxes.shape[0]
    dev = boxes.device
    alive = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid.bool()
    # greedy order: score descending, first index on ties
    order = torch.sort(scores, descending=True, stable=True).indices
    b = boxes[order]
    alive_s = alive[order]
    # sup[j, i] for j < i in that order, held block by block as (rows j, all i)
    pos = torch.arange(n, device=dev)
    blocks = []
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        sup = (box_iou(b[lo:hi], b) > iou_threshold) & (pos[lo:hi, None] < pos[None, :])
        blocks.append(sup & alive_s[lo:hi, None] & alive_s[None, :])

    def cond(kept, changed, it, alive_s, *blocks):
        return changed & (it < n)

    def body(kept, changed, it, alive_s, *blocks):
        suppressed = torch.zeros_like(kept)
        for lo, sup in zip(range(0, n, block), blocks):
            suppressed = suppressed | (sup & kept[lo:lo + sup.shape[0], None]).any(dim=0)
        new = alive_s & ~suppressed
        return new, (new != kept).any(), it + 1

    carried = (alive_s, torch.ones((), dtype=torch.bool, device=dev),
               torch.zeros((), dtype=torch.int64, device=dev))
    with torch.profiler.record_function("nms.while_loop"):
        kept_s = while_loop_op(cond, body, carried, (alive_s, *blocks))[0]
    # the selection order: the kept boxes by (score desc, index asc), the
    # stable top-k of their scores as lax.top_k gives it
    kept = torch.zeros_like(kept_s).scatter(0, order, kept_s)
    k = min(max_out, n)
    top, idx = top_k_stable(torch.where(kept, scores, -float("inf")), k)
    keep_valid = torch.zeros(max_out, dtype=torch.bool, device=dev)
    keep_idx = torch.zeros(max_out, dtype=torch.int32, device=dev)
    keep_valid[:k] = top > -float("inf")
    keep_idx[:k] = torch.where(keep_valid[:k], idx, 0).int()
    return keep_idx, keep_valid


def batched_nms(boxes, scores, idxs, iou_threshold: float, max_out: int, valid=None):
    """Category/level-aware NMS via the coordinate-offset trick: boxes of
    different ``idxs`` never suppress each other."""
    span = torch.maximum(boxes[:, 2], boxes[:, 3]).max() + 1.0
    shifted = boxes + idxs.to(boxes.dtype)[:, None] * span
    return nms(shifted, scores, iou_threshold, max_out, valid=valid)
