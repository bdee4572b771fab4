"""Attention forward with and without the head-averaged probability capture.

Port of ``attentionshift_tpu/ops/attention.py`` (forward only):

    out        = softmax(q k^T / sqrt(d)) v        (per head)
    mean_probs = mean_h softmax(.)                 (capture blocks only)

with an optional pre-padded token gap ``pad_interval = [lo, hi)`` masked
out of every softmax (``models/vit.py`` ``pad_tokens_to``).

Each public function is a wrapper: a CPU tensor takes the plain PyTorch
version (``attention_reference``, which follows the JAX package's
``_jnp_reference``), a CUDA tensor launches the hand-written kernel in
``csrc/attention.cu`` or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KERNELS, check, library

__all__ = ["attention_reference", "attention_with_capture", "attention_no_capture"]

_LOG2E = 1.4426950408889634


def attention_reference(q, k, v, pad_interval=None):
    """Plain version: (B, H, T, d) -> (out (B,H,T,d), mean (B,T,T)) in q.dtype.

    Logits and softmax in f32 from the storage-dtype operands (bf16 x bf16
    products are exact in f32, so this is the JAX ``preferred_element_type
    =f32`` contraction); probabilities are rounded to v's dtype for the
    PV product, as in the JAX package.
    """
    d = q.shape[-1]
    logits = torch.matmul((q * d**-0.5).float(), k.float().transpose(-1, -2))
    if pad_interval is not None:
        lo, hi = pad_interval
        col = torch.arange(q.shape[2], device=q.device)
        logits = logits + torch.where((col >= lo) & (col < hi), -1e30, 0.0)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, probs.mean(dim=1).to(q.dtype)


def _check_inputs(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention kernel: q, k, v must all be CUDA tensors")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention kernel: q/k/v shapes differ or are not 4-D: {tuple(q.shape)}")
    if q.shape[-1] != 64:
        raise ValueError(f"attention kernel takes head dim 64, got {q.shape[-1]}")


def _gap(t, pad_interval):
    # an empty interval [t, t) masks nothing beyond the columns >= t the
    # kernel always masks
    if pad_interval is None:
        return t, t
    return int(pad_interval[0]), int(pad_interval[1])


def _flash(q, k, v, pad_interval, with_lse):
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32) if with_lse else None
    lo, hi = _gap(t, pad_interval)
    lib = library("attention")
    fn = lib.attn_flash_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if with_lse else None, b, h, t, lo, hi,
             d**-0.5 * _LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "attn_flash_forward")
    return out, lse


def attention_no_capture(q, k, v, pad_interval=None):
    """Attention without the probability output (the non-capture blocks)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, pad_interval)[0]
    _check_inputs(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, _ = _flash(q, k, v, pad_interval, with_lse=False)
    KERNELS["attention_plain"].launches += 1
    return out


def attention_with_capture(q, k, v, pad_interval=None):
    """Attention + head-averaged probabilities (B, T, T) in q.dtype.

    On the card: the flash pass writes ``out`` and each head's row
    log2-sum-exp, then the mean pass recomputes the probabilities tile by
    tile, sums the heads and writes the mean once.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, pad_interval)
    _check_inputs(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, h, t, d = q.shape
    out, lse = _flash(q, k, v, pad_interval, with_lse=True)
    mean = torch.empty((b, t, t), device=q.device, dtype=q.dtype)
    lo, hi = _gap(t, pad_interval)
    fn = library("attention").attn_mean_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), lse.data_ptr(),
             mean.data_ptr(), b, h, t, lo, hi, d**-0.5 * _LOG2E,
             torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "attn_mean_forward")
    KERNELS["attention_capture"].launches += 1
    return out, mean

