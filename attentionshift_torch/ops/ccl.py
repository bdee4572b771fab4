"""Connected-component labelling of binary masks.

Port of ``attentionshift_tpu/ops/ccl.py``: iterative min-label
propagation. Each sweep takes the 3x3 minimum (8-connectivity), then the
minimum over every vertical and every horizontal foreground run; the
fixpoint stops when a sweep changes nothing or after ``max_iters``
sweeps. Labels: background 0, a component's label is its minimum flat
index + 1 (the cc_torch numbering).

``connected_components_batch`` is the wrapper: a CPU tensor takes the
plain version ``connected_components`` (which follows the JAX
``connected_components``), a CUDA tensor launches ``csrc/ccl.cu`` or
raises. The kernel keeps a plane in shared memory when its buffer
(``_plane_bytes``) fits, else in a scratch buffer in device memory.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import KERNELS, check, library

__all__ = ["connected_components", "connected_components_batch"]

_BIG = 2**31 - 1
_SMEM_LIMIT = 227 * 1024


def _neighbor_min(labels: torch.Tensor) -> torch.Tensor:
    """3x3 window minimum over the last two axes, out-of-range ignored."""
    m, h, w = labels.shape
    p = F.pad(labels, (1, 1, 1, 1), value=_BIG)
    out = labels
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, p[:, dy:dy + h, dx:dx + w])
    return out


def _run_min(vals: torch.Tensor, blocked: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward then reverse segmented min-scan along ``dim`` (runs of
    unblocked cells), Hillis-Steele with power-of-two shifts."""
    n = vals.shape[dim]

    def shift(x, s, fill, forward):
        pad_shape = list(x.shape)
        pad_shape[dim] = s
        f = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
        if forward:
            return torch.cat([f, x.narrow(dim, 0, n - s)], dim=dim)
        return torch.cat([x.narrow(dim, s, n - s), f], dim=dim)

    for forward in (True, False):
        v, b = vals, blocked
        s = 1
        while s < n:
            v2 = shift(v, s, _BIG, forward)
            b2 = shift(b, s, True, forward)
            v = torch.where(b, v, torch.minimum(v, v2))
            b = b | b2
            s *= 2
        vals = v
    return vals


def connected_components(masks: torch.Tensor, max_iters: int = 256,
                         return_sweeps: bool = False):
    """Plain version: (M, H, W) bool -> (M, H, W) int32 labels.

    All planes sweep together; a converged plane is a fixpoint, so each
    plane gets what it would get alone. One host check per sweep. With
    ``return_sweeps`` also returns the (M,) sweeps each plane ran, the
    one that found it unchanged included (the kernel's per-plane work).
    """
    m, h, w = masks.shape
    fg = masks.bool()
    blocked = ~fg
    idx = torch.arange(h * w, dtype=torch.int64, device=masks.device).reshape(1, h, w)
    labels = torch.where(fg, idx, _BIG)
    active = torch.ones(m, dtype=torch.bool, device=masks.device)
    sweeps = torch.zeros(m, dtype=torch.int32, device=masks.device)
    for _ in range(max_iters):
        new = torch.where(fg, torch.minimum(labels, _neighbor_min(labels)), _BIG)
        new = _run_min(new, blocked, 1)
        new = _run_min(new, blocked, 2)
        new = torch.where(fg, new, _BIG)
        sweeps += active
        active = (new != labels).flatten(1).any(1)
        labels = new
        if not bool(active.any()):
            break
    out = torch.where(fg, labels + 1, 0).to(torch.int32)
    return (out, sweeps) if return_sweeps else out


def _plane_bytes(h: int, w: int) -> int:
    """Bytes of one plane's working buffer in ``csrc/ccl.cu``: both label
    buffers (int32) and the mask (one byte) on (h + 2) rows of an odd
    stride >= w + 2 (a one-cell border), rounded up to 16 bytes."""
    cells = (h + 2) * ((w + 2) | 1)
    return -(-cells * 9 // 16) * 16


def connected_components_batch(masks: torch.Tensor, max_iters: int = 256,
                               lib=None) -> torch.Tensor:
    """Label many (M, H, W) masks at once (8-connectivity). ``lib``: a build
    of ``csrc/ccl.cu`` with ``-D`` overrides (``_build.library``)."""
    if masks.device.type == "cpu":
        return connected_components(masks, max_iters)
    if not masks.is_cuda or masks.dim() != 3:
        raise ValueError(f"ccl kernel takes a 3-D CUDA mask tensor, got {tuple(masks.shape)}")
    m, h, w = masks.shape
    fg = masks.to(torch.bool).contiguous()
    out = torch.empty((m, h, w), dtype=torch.int32, device=masks.device)
    smem = _plane_bytes(h, w)
    if smem <= _SMEM_LIMIT:
        scratch = out  # unused: the plane's buffers live in shared memory
    else:
        scratch = torch.empty((m * smem,), dtype=torch.uint8, device=masks.device)
        smem = 0
    fn = (lib or library("ccl")).ccl_batch_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    err = fn(fg.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, h, w, int(max_iters), smem,
             torch.cuda.current_stream(masks.device).cuda_stream)
    check(err, "ccl_batch_forward")
    KERNELS["ccl_batch"].launches += 1
    return out
