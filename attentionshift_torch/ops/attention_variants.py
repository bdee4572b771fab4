"""Design variants of the capture-attention forward.

Port of the five experimental kernels of the JAX package's attention
microbenchmark (``tools/analysis/microbench_attention.py``, ``v2`` ...
``v6``). Each takes q, k, v (B, H, T, 64) and returns

    out  (B, H, T, 64)   softmax(q k^T / sqrt(d)) v per head
    mean (B, T, T)       the head-averaged probabilities

with the TPU kernels' constant-shift softmax: q is scaled by
``d^-0.5 * log2(e)`` in the storage dtype, the logits are shifted by -20
in the log2 domain instead of by the row maximum, ``e = exp2(.)`` is
rounded to bf16 before the row sum, the PV product and the mean, and the
division by the row sum comes after PV. There is no masked gap; every
row and column of any T is computed. The variants differ in one choice:

    v2-bf16e     the base: clamp ``min(logit, 100)``, row sum of the bf16
                 e in f32, heads one after the other
    v3-nomin     v2 without the clamp
    v4-mxsum     v2 with the row sum as a matrix product ``e @ ones(T, 8)``
    v5-batched   v2 with all heads at once; mean = mean over the head axis
    v6-fusedsum  v2 with the row sum folded into PV: V gets 8 all-ones
                 columns and the denominator is column 64 of the product

``attention_variant`` is the wrapper: a CPU tensor takes the plain
PyTorch version ``variant_reference``, which repeats the variant's
arithmetic step by step; a CUDA tensor launches the hand-written kernel
in ``csrc/attention_variants.cu`` or raises. There is no fallback
between the two, and no gradient: the variants are forward experiments.
v2 and v4 run two kernels per call (an out pass that also writes each
row's reciprocal row sum into a (B, H, T) f32 workspace, then a mean
pass that reads it), counted as one launch, as the capture pair of
``ops/attention.py`` is.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KERNELS, check, library

__all__ = ["VARIANTS", "variant_reference", "attention_variant", "variant_library", "clamp_case"]

_LOG2E = 1.4426950408889634
_SOFTMAX_SHIFT = 20.0

# tool name -> (kernel record, variant number of the C interface)
VARIANTS = {
    "v2-bf16e": ("attention_v2_bf16e", 2),
    "v3-nomin": ("attention_v3_nomin", 3),
    "v4-mxsum": ("attention_v4_mxsum", 4),
    "v5-batched": ("attention_v5_batched", 5),
    "v6-fusedsum": ("attention_v6_fusedsum", 6),
}


def _q_scale(q):
    """d^-0.5 * log2(e) rounded to q's dtype, as the TPU kernels fold it
    into the query tile (a 0-dim CPU tensor: no device read to get its value)."""
    return torch.tensor(q.shape[-1] ** -0.5 * _LOG2E, dtype=q.dtype)


def _with_ones(v):
    """V with 8 all-ones columns appended: (B, H, T, d + 8)."""
    return torch.cat([v, v.new_ones((*v.shape[:-1], 8))], dim=-1)


def variant_reference(q, k, v, variant: str):
    """Plain version of one variant: (out (B,H,T,d), mean (B,T,T)) in
    q.dtype."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown attention variant {variant!r}; known: {sorted(VARIANTS)}")
    b, h, t, d = q.shape
    qs = q * _q_scale(q)  # rounded to the storage dtype
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2)) - _SOFTMAX_SHIFT
    if variant != "v3-nomin":
        logits = logits.clamp(max=100.0)
    e = torch.exp2(logits).to(torch.bfloat16).float()
    if variant == "v6-fusedsum":
        osum = torch.matmul(e, _with_ones(v).float())  # PV in [:d], row sum in [d:]
        pv, s = osum[..., :d], osum[..., d:d + 1]
    else:
        pv = torch.matmul(e, v.float())
        if variant == "v4-mxsum":
            s = torch.matmul(e, e.new_ones((t, 8)))[..., :1]
        else:
            s = e.sum(dim=-1, keepdim=True)
    recip = 1.0 / s.clamp_min(1e-30)
    out = (pv * recip).to(q.dtype)
    if variant == "v5-batched":
        mean = (e * recip).mean(dim=1)
    else:
        mean = None
        for hh in range(h):
            contrib = e[:, hh] * (recip[:, hh] * (1.0 / h))
            mean = contrib if mean is None else mean + contrib
    return out, mean.to(q.dtype)


def _check_inputs(q, k, v, variant):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention variant kernel takes bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention variant kernel: q/k/v shapes differ or are not 4-D: {tuple(q.shape)}")
    if q.shape[-1] != 64:
        raise ValueError(f"attention variant kernel takes head dim 64, got {q.shape[-1]}")
    if variant == "v5-batched" and q.shape[1] > 8:
        raise ValueError(f"attention variant kernel v5-batched runs at most 8 heads side by "
                         f"side, got {q.shape[1]}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention variant kernel: q, k, v must all be CUDA tensors")


def variant_library(defines=()):
    """``csrc/attention_variants.cu``'s library (built with the ``-D``
    overrides ``defines``), its entry point's signature set."""
    lib = library("attention_variants", defines)
    fn = lib.attn_variant_forward
    if fn.argtypes is None:  # first use of this library
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _workspace(q, number):
    """v2's and v4's (B, H, T) f32 workspace (each row's reciprocal row
    sum, from the out pass to the mean pass); None for the others."""
    b, h, t, _ = q.shape
    return torch.empty((b, h, t), device=q.device, dtype=torch.float32) if number in (2, 4) else None


def _launch(fn, variant, q, k, v, stream):
    """One call of ``attn_variant_forward`` (``fn``) on contiguous inputs
    on ``stream``: (out, mean), one launch counted."""
    name, number = VARIANTS[variant]
    b, h, t, d = q.shape
    v = _with_ones(v) if variant == "v6-fusedsum" else v
    out = torch.empty_like(q)
    mean = torch.empty((b, t, t), device=q.device, dtype=q.dtype)
    work = _workspace(q, number)
    check(fn(number, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), mean.data_ptr(),
             None if work is None else work.data_ptr(), b, h, t, float(_q_scale(q)), stream),
          f"attn_variant_forward({variant})")
    KERNELS[name].launches += 1
    return out, mean


def attention_variant(q, k, v, variant: str, lib=None):
    """One variant's (out, mean): the kernel on the card (through ``lib``,
    default ``variant_library()``), the plain version on the CPU."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown attention variant {variant!r}; known: {sorted(VARIANTS)}")
    if q.device.type == "cpu":
        return variant_reference(q, k, v, variant)
    _check_inputs(q, k, v, variant)
    lib = variant_library() if lib is None else lib
    return _launch(lib.attn_variant_forward, variant, q.contiguous(), k.contiguous(),
                   v.contiguous(), torch.cuda.current_stream(q.device).cuda_stream)


# the clamp input: query row, the two key columns, and values exact in bf16
# with q.k = 64 * (4 * bf16(scale)) * key value, bf16(0.125 * log2 e) = 185/1024
_CLAMP_ROW, _CLAMP_COLS = 3, (5, 9)
_CLAMP_Q = 4.0
_CLAMP_K = (2.8125, 2.6875)  # 64 * 185/256 * . - 20 = 110.08 and 104.30


def clamp_case(q, k, v):
    """Copies of q, k, v (head dim 64) in which query row 3 of every head
    has two shifted log2 logits inside (100, 127): about 110 at key 5 and
    about 104 at key 9, every other logit of the row far below. The
    clamped variants give both keys e = 2^100, so that row of ``out`` is
    the even mix of their values; v3 keeps 2^110 and 2^104, a 55:1 mix."""
    q, k, v = q.clone(), k.clone(), v.clone()
    q[:, :, _CLAMP_ROW] = _CLAMP_Q
    for col, val in zip(_CLAMP_COLS, _CLAMP_K):
        k[:, :, col] = val
    return q, k, v
