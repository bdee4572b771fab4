"""Fixed-shape exact greedy NMS.

Port of ``attentionshift_tpu/ops/nms.py``: up to ``max_out`` kept boxes
as padded indices plus a validity mask; precedence is higher score
first, first index on ties; level/class-aware behaviour through the
coordinate-offset trick. Greedy NMS is computed as the fixpoint of
"kept = alive and not suppressed by a kept box of higher precedence",
on boxes sorted by precedence, in row blocks so that no (N, N) matrix is
held at once (N = 8819 at the 800x1344 train shape).
"""

from __future__ import annotations

import torch

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
    kept = alive_s.clone()
    blocks = []
    pos = torch.arange(n, device=dev)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        sup = (box_iou(b[lo:hi], b) > iou_threshold) & (pos[lo:hi, None] < pos[None, :])
        blocks.append((lo, hi, sup & alive_s[lo:hi, None] & alive_s[None, :]))
    for _ in range(n):
        suppressed = torch.zeros(n, dtype=torch.bool, device=dev)
        for lo, hi, sup in blocks:
            suppressed |= (sup & kept[lo:hi, None]).any(dim=0)
        new = alive_s & ~suppressed
        # the fixpoint's one host read per iteration, named for the profiler
        with torch.profiler.record_function("nms.fixpoint_read"):
            done = bool((new == kept).all())
        if done:
            break
        kept = new
    k = min(max_out, n)
    rank = torch.nonzero(kept)[:, 0][:k]  # already in selection order
    keep_idx = torch.zeros(max_out, dtype=torch.int32, device=dev)
    keep_valid = torch.zeros(max_out, dtype=torch.bool, device=dev)
    keep_idx[:rank.shape[0]] = order[rank].int()
    keep_valid[:rank.shape[0]] = scores[order[rank]] > -float("inf")
    return torch.where(keep_valid, keep_idx, 0).int(), keep_valid


def batched_nms(boxes, scores, idxs, iou_threshold: float, max_out: int, valid=None):
    """Category/level-aware NMS via the coordinate-offset trick: boxes of
    different ``idxs`` never suppress each other."""
    span = torch.maximum(boxes[:, 2], boxes[:, 3]).max() + 1.0
    shifted = boxes + idxs.to(boxes.dtype)[:, None] * span
    return nms(shifted, scores, iou_threshold, max_out, valid=valid)
