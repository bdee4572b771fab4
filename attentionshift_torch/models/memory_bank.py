"""Cross-image object memory bank and its align loss.

Port of ``attentionshift_tpu/models/memory_bank.py``: one fixed-shape
bank of tensors (classes x queue x parts x dim) with validity masks, a
circular append per class, retrieval gated by token cosine >
``appear_thresh`` and box aspect ratio within ``ratio_range``, and the
align loss (the min cosine distance from each part of an object to the
parts of its retrieved same-class peers). Plain tensor code: no kernel.
The bank lives on the device ``init_bank`` puts it on (``cuda`` unless
asked otherwise); every other function computes where its tensors are
and reads nothing back to the host. ``bank_append`` returns a new bank,
as the JAX function does, and leaves its argument as it was.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

__all__ = ["MemoryBank", "init_bank", "bank_append", "retrieve_similar", "align_loss"]


class MemoryBank(NamedTuple):
    tokens: torch.Tensor  # (C, Q, D)
    part_feats: torch.Tensor  # (C, Q, P, D)
    part_valid: torch.Tensor  # (C, Q, P) bool
    boxes: torch.Tensor  # (C, Q, 4)
    slot_valid: torch.Tensor  # (C, Q) bool
    ptr: torch.Tensor  # (C,) int32 circular write pointer


def init_bank(num_classes: int, queue_len: int, max_parts: int, dim: int,
              device=None) -> MemoryBank:
    dev = resolve_device(device)
    return MemoryBank(
        tokens=torch.zeros((num_classes, queue_len, dim), device=dev),
        part_feats=torch.zeros((num_classes, queue_len, max_parts, dim), device=dev),
        part_valid=torch.zeros((num_classes, queue_len, max_parts), dtype=torch.bool, device=dev),
        boxes=torch.zeros((num_classes, queue_len, 4), device=dev),
        slot_valid=torch.zeros((num_classes, queue_len), dtype=torch.bool, device=dev),
        ptr=torch.zeros((num_classes,), dtype=torch.int32, device=dev),
    )


def bank_append(bank: MemoryBank, class_idx, token, part_feats, part_valid, box,
                enable=True) -> MemoryBank:
    """Circular-append ONE object into its class queue; with ``enable``
    false the bank comes back unchanged."""
    dev = bank.ptr.device
    c = torch.as_tensor(class_idx, device=dev).long().reshape(1)
    q = bank.ptr[c].long()
    en = torch.as_tensor(enable, device=dev)

    def put(arr, val):
        val = torch.as_tensor(val, device=dev).to(arr.dtype)
        return arr.index_put((c, q), torch.where(en, val, arr[c, q][0]).unsqueeze(0))

    return MemoryBank(
        tokens=put(bank.tokens, token),
        part_feats=put(bank.part_feats, part_feats),
        part_valid=put(bank.part_valid, part_valid),
        boxes=put(bank.boxes, box),
        slot_valid=put(bank.slot_valid, True),
        ptr=bank.ptr.index_put((c,), torch.where(en, (q + 1) % bank.tokens.shape[1], q).int()),
    )


def _cos(a, b, eps: float = 1e-5):
    na = torch.linalg.norm(a, dim=-1, keepdim=True).clamp_min(eps)
    nb = torch.linalg.norm(b, dim=-1, keepdim=True).clamp_min(eps)
    return (a / na) @ (b / nb).transpose(-1, -2)


def _aspect(box):
    return (box[..., 2] - box[..., 0]) / (box[..., 3] - box[..., 1]).clamp_min(1e-5)


def retrieve_similar(bank: MemoryBank, class_idx, token, box, appear_thresh: float = 0.7,
                     ratio_range: tuple[float, float] = (0.5, 2.0)) -> torch.Tensor:
    """(Q,) bool retrieval mask over the class queue: token cosine >
    ``appear_thresh`` and the ratio of the aspect ratios within
    ``ratio_range``, among the filled slots."""
    c = torch.as_tensor(class_idx, device=bank.ptr.device).long()
    token_sim = _cos(token[None], bank.tokens[c])[0].clamp_min(0.0)  # (Q,)
    ratio = _aspect(box) / _aspect(bank.boxes[c]).clamp_min(1e-5)
    return ((token_sim > appear_thresh) & (ratio >= ratio_range[0]) & (ratio <= ratio_range[1])
            & bank.slot_valid[c])


def align_loss(bank: MemoryBank, class_idx, token, part_feats, part_valid, box,
               appear_thresh: float = 0.7,
               ratio_range: tuple[float, float] = (0.5, 2.0)) -> torch.Tensor:
    """Cross-image align loss for one object: the min cosine distance from
    each of its parts to the parts of the retrieved peers, averaged over
    its valid parts; 0 when nothing is retrievable."""
    c = torch.as_tensor(class_idx, device=bank.ptr.device).long()
    keep = retrieve_similar(bank, class_idx, token, box, appear_thresh, ratio_range)
    peer_feats = bank.part_feats[c]  # (Q, P, D)
    peer_valid = bank.part_valid[c] & keep[:, None]  # (Q, P)
    dist = 1.0 - _cos(part_feats, peer_feats.reshape(-1, peer_feats.shape[-1]))  # (Pq, Q*P)
    dist = torch.where(peer_valid.reshape(-1)[None, :], dist, torch.inf)
    min_d = dist.amin(dim=-1)  # (Pq,)
    usable = part_valid & torch.isfinite(min_d)
    min_d = torch.where(usable, min_d, 0.0)
    return min_d.sum() / usable.sum().clamp_min(1)
