"""Attention with and without the head-averaged probability capture.

Port of ``attentionshift_tpu/ops/attention.py``, forward and backward:

    out        = softmax(q k^T / sqrt(d)) v        (per head)
    mean_probs = mean_h softmax(.)                 (capture blocks only)

with an optional pre-padded token gap ``pad_interval = [lo, hi)`` masked
out of every softmax (``models/vit.py`` ``pad_tokens_to``).

The two public functions are wrappers around two ``torch.library``
custom ops, ``attentionshift::attention_plain`` and
``attentionshift::attention_capture``, so that ``torch.export`` keeps each
as one operator of the exported graph and ``FlopCounterMode`` counts it
(``attention_flops``). A CPU tensor takes the plain PyTorch versions
(``attention_reference``, which follows the JAX package's
``_jnp_reference``, and ``attention_backward_reference``, which follows
its staged backward), a CUDA tensor launches the hand-written kernels in
``csrc/attention.cu`` and ``csrc/attention_bwd.cu`` or raises; the fake
implementations give the outputs' shapes and dtypes. There is no
fallback between the two. The gradient is registered on both ops
(``register_autograd``); ``mean_probs`` carries none.

The backward on the card is two kernels: pass A gives dQ and the per-row
D = sum_s p * dP (f32, from the bf16 p, as the TPU kernel), pass B gives
dK and dV. The row normaliser of the
recomputed probabilities is the forward's log2-sum-exp, which the flash
pass writes whenever a gradient may be asked for.

The kernels take head dim 64 (the ViTs) and 32 (Swin's global blocks),
each an instance of its own, and any number of heads: the mean pass keeps
every head's query tile while they fit (``attn_mean_resident_heads``)
and streams them above that. Launches of the head-dim-32 instances are
counted under their own names, ``<kernel>_d32``. Any other head dim
raises ``ValueError`` on a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from ..parallel.collectives import all_reduce
from ._build import KERNELS, check, library
from .numerics import F32_MIN_NORMAL, bf16_steps

__all__ = ["HEAD_DIMS", "attention_reference", "attention_backward_reference",
           "attention_with_capture", "attention_no_capture", "attention_with_capture_sharded",
           "attention_no_capture_sharded", "reduce_capture", "attention_plain_op",
           "attention_capture_op", "attention_flops", "flash_forward", "forward_library",
           "attention_backward_dq", "attention_backward_dkv", "capture_mean_limit", "kernel_name"]

_LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 32)  # the head dims the kernels have instances for


def kernel_name(name: str, d: int) -> str:
    """The ``KERNELS`` record that counts ``name``'s launches at head dim
    ``d``: the name itself at 64, ``<name>_d32`` at 32."""
    return name if d == 64 else f"{name}_d{d}"


def _logits(q, k):
    """q k^T d^-0.5 in f32: the storage-dtype product, then the scale."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5


def attention_reference(q, k, v, pad_interval=None):
    """Plain version: (B, H, T, d) -> (out (B,H,T,d), mean (B,T,T)) in q.dtype.

    Logits and softmax in f32 from the storage-dtype operands (bf16 x bf16
    products are exact in f32, so this is the JAX ``preferred_element_type
    =f32`` contraction); probabilities are rounded to v's dtype for the
    PV product, as in the JAX package. The scale d^-0.5 multiplies the f32
    logits, as the kernels apply it: at head dim 64 (0.125, a power of
    two) that is bitwise what scaling q first gives; at 32 it leaves out a
    rounding of q * d^-0.5 to the storage dtype, which neither the kernels
    nor an f32 model make.
    """
    logits = _logits(q, k)
    if pad_interval is not None:
        lo, hi = pad_interval
        col = torch.arange(q.shape[2], device=q.device)
        logits = logits + torch.where((col >= lo) & (col < hi), -1e30, 0.0)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, probs.mean(dim=1).to(q.dtype)


def capture_mean_limit(want_mean):
    """Per-entry limit of the kernels' head mean against the plain
    version's: one bf16 step of each entry, plus 2^-126.

    Both sides compute one f32 mean of the same probabilities and round it
    to bf16. The f32 means differ by ~2^-17 of the entry at most (the
    kernel's ex2.approx against ``torch.softmax``'s exp, and the order of
    the row and head sums), far under a bf16 step (2^-8 of the entry), so
    the roundings can fall one step apart and no further. Where the
    kernel's exp2 flushes a subnormal probability to 0 the entry is below
    2^-126: hence the absolute term. The limit is per entry because a
    limit relative to the largest entry falls below one step of the
    entries near it when the mean is flat (entries near 1/T).
    """
    return bf16_steps(want_mean) + F32_MIN_NORMAL


def _check_inputs(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention kernel: q, k, v must all be CUDA tensors")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention kernel: q/k/v shapes differ or are not 4-D: {tuple(q.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dim {' or '.join(map(str, HEAD_DIMS))}, "
                         f"got {q.shape[-1]}")


def _require_contiguous(fn: str, *tensors) -> None:
    """The kernels read and write row-major buffers through raw pointers:
    a strided view (a head-split ``qkv``) would be read as garbage."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: every tensor must be contiguous (call .contiguous() first)")


def _gap(t, pad_interval):
    # an empty interval [t, t) masks nothing beyond the columns >= t the
    # kernel always masks
    if pad_interval is None:
        return t, t
    return int(pad_interval[0]), int(pad_interval[1])


def forward_library(defines=()):
    """``csrc/attention.cu``'s library (built with the ``-D`` overrides
    ``defines``), its entry points' signatures set."""
    lib = library("attention", defines)
    if lib.attn_mean_forward.argtypes is None:  # first use of this library
        tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.attn_flash_forward.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.attn_mean_forward.argtypes = [ctypes.c_void_p] * 4 + tail
        lib.attn_mean_resident_heads.argtypes = [ctypes.c_int]
        for fn in (lib.attn_flash_forward, lib.attn_mean_forward, lib.attn_mean_resident_heads):
            fn.restype = ctypes.c_int
    return lib


def flash_forward(q, k, v, pad_interval, with_lse, lib=None):
    """The flash pass on the card: (out, row log2-sum-exp (B, H, T) f32 or
    None), through ``lib`` (default: ``forward_library()``). Counts no
    launch: the two attention ops do."""
    _require_contiguous("flash_forward", q, k, v)
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32) if with_lse else None
    lo, hi = _gap(t, pad_interval)
    lib = forward_library() if lib is None else lib
    err = lib.attn_flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 lse.data_ptr() if with_lse else None, b, h, t, d, lo, hi,
                                 d**-0.5 * _LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "attn_flash_forward")
    return out, lse


def attention_backward_reference(q, k, v, g_out, pad_interval=None):
    """Plain backward: (dq, dk, dv) of ``attention_reference``'s ``out``.

    The staged form of the JAX package: the recomputed probabilities and
    p * (dP - D) are rounded to the storage dtype before the products that
    consume them, every product accumulates in f32, D = sum_s p * dP. In
    f32 this is the exact softmax-attention gradient. Columns in the gap
    have p == 0, so their dk and dv are exactly zero.
    """
    mm = q.dtype
    d = q.shape[-1]
    g = g_out.to(mm).float()
    logits = _logits(q, k)
    if pad_interval is not None:
        lo, hi = pad_interval
        col = torch.arange(q.shape[2], device=q.device)
        logits = logits + torch.where((col >= lo) & (col < hi), -1e30, 0.0)
    pm = torch.softmax(logits, dim=-1).to(mm).float()
    gv = torch.matmul(pm.transpose(-1, -2), g)
    gp = torch.matmul(g, v.float().transpose(-1, -2))
    dd = (pm * gp).sum(dim=-1, keepdim=True)
    glm = (pm * (gp - dd)).to(mm).float()
    gq = torch.matmul(glm, k.float()) * d**-0.5
    gk = torch.matmul(glm.transpose(-1, -2), q.float()) * d**-0.5
    return gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype)


_BWD_TAIL = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def attention_backward_dq(q, k, v, lse, g_out, pad_interval=None):
    """Backward pass A on the card: (dq, D) with D = sum_s p * dP per row
    (B, H, T) f32, from ``flash_forward``'s row statistic. D is summed in
    f32 from the bf16 p, as the TPU kernel and ``attention_backward_reference``
    do."""
    _check_inputs(q, k, v)
    _require_contiguous("attention_backward_dq", q, k, v, lse, g_out)
    b, h, t, d = q.shape
    dq = torch.empty_like(q)
    dd = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    lo, hi = _gap(t, pad_interval)
    fn = library("attention_bwd").attn_backward_dq
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + _BWD_TAIL
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
             lse.data_ptr(), dq.data_ptr(), dd.data_ptr(), b, h, t, d, lo, hi, d**-0.5 * _LOG2E,
             d**-0.5, torch.cuda.current_stream(q.device).cuda_stream), "attn_backward_dq")
    KERNELS[kernel_name("attention_bwd_dq", d)].launches += 1
    return dq, dd


def attention_backward_dkv(q, k, v, lse, dd, g_out, pad_interval=None):
    """Backward pass B on the card: (dk, dv), from the forward's row
    statistic and pass A's D. Gap columns come out exactly zero."""
    _check_inputs(q, k, v)
    _require_contiguous("attention_backward_dkv", q, k, v, lse, dd, g_out)
    b, h, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lo, hi = _gap(t, pad_interval)
    fn = library("attention_bwd").attn_backward_dkv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + _BWD_TAIL
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(), lse.data_ptr(),
             dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, d, lo, hi, d**-0.5 * _LOG2E,
             d**-0.5, torch.cuda.current_stream(q.device).cuda_stream), "attn_backward_dkv")
    KERNELS[kernel_name("attention_bwd_dkv", d)].launches += 1
    return dk, dv


def _pad(lo: int, hi: int):
    """The custom ops' gap [lo, hi) as ``pad_interval`` (None when empty)."""
    return (lo, hi) if lo < hi else None


def _row_lse(q, k, pad_interval):
    """The plain version of the flash pass's row log2-sum-exp (B, H, T) f32."""
    logits = _logits(q, k)
    if pad_interval is not None:
        lo, hi = pad_interval
        col = torch.arange(q.shape[2], device=q.device)
        logits = logits + torch.where((col >= lo) & (col < hi), -1e30, 0.0)
    return torch.logsumexp(logits, dim=-1) * _LOG2E


# The two forward ops as torch.library custom ops, so that torch.export and
# FlopCounterMode see one operator each: the CPU implementation is the plain
# version, the CUDA one launches the kernels (and counts the launch), the fake
# one gives shapes and dtypes. Each returns the row log2-sum-exp as well,
# which the backward (register_autograd below) reads.
@torch.library.custom_op("attentionshift::attention_plain", mutates_args=(), device_types="cpu")
def attention_plain_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lo: int,
                       hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, row log2-sum-exp) of attention with the gap [lo, hi) masked."""
    out, _ = attention_reference(q, k, v, _pad(lo, hi))
    return out, _row_lse(q, k, _pad(lo, hi))


@attention_plain_op.register_kernel("cuda")
def _plain_cuda(q, k, v, lo, hi):
    _check_inputs(q, k, v)
    out, lse = flash_forward(q, k, v, _pad(lo, hi), with_lse=True)
    KERNELS[kernel_name("attention_plain", q.shape[-1])].launches += 1
    return out, lse


@attention_plain_op.register_fake
def _plain_fake(q, k, v, lo, hi):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("attentionshift::attention_capture", mutates_args=(), device_types="cpu")
def attention_capture_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lo: int,
                         hi: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, head-mean probabilities (B, T, T), row log2-sum-exp)."""
    out, mean = attention_reference(q, k, v, _pad(lo, hi))
    return out, mean, _row_lse(q, k, _pad(lo, hi))


@attention_capture_op.register_kernel("cuda")
def _capture_cuda(q, k, v, lo, hi):
    _check_inputs(q, k, v)
    out, lse = flash_forward(q, k, v, _pad(lo, hi), with_lse=True)
    mean = _mean(q, k, lse, _pad(lo, hi))
    KERNELS[kernel_name("attention_capture", q.shape[-1])].launches += 1
    return out, mean, lse


@attention_capture_op.register_fake
def _capture_fake(q, k, v, lo, hi):
    b, h, t, _ = q.shape
    return (torch.empty_like(q), q.new_empty((b, t, t)),
            q.new_empty((b, h, t), dtype=torch.float32))


def _setup(ctx, inputs, output):
    q, k, v, lo, hi = inputs
    ctx.pad_interval = _pad(lo, hi)
    ctx.mark_non_differentiable(*output[1:])
    ctx.save_for_backward(q, k, v, output[-1])


def _backward(ctx, g_out, *_):
    q, k, v, lse = ctx.saved_tensors
    if q.device.type == "cpu":
        grads = attention_backward_reference(q, k, v, g_out, ctx.pad_interval)
    else:
        g_out = g_out.to(q.dtype).contiguous()
        dq, dd = attention_backward_dq(q, k, v, lse, g_out, ctx.pad_interval)
        grads = (dq, *attention_backward_dkv(q, k, v, lse, dd, g_out, ctx.pad_interval))
    return (*grads, None, None)


for _op in (attention_plain_op, attention_capture_op):
    _op.register_autograd(_backward, setup_context=_setup)


@register_flop_formula([torch.ops.attentionshift.attention_plain,
                        torch.ops.attentionshift.attention_capture])
def attention_flops(q_shape, *args, **kwargs) -> int:
    """The two products QK^T and PV, 2 operations per multiply-add:
    4 B H T^2 d, the count of ``chip_smoke.py``'s bound of kernel #2 (and
    of #1's flash pass; the mean pass's recompute is not counted)."""
    b, h, t, d = q_shape
    return 4 * b * h * t * t * d


def _operands(q, k, v):
    """The ops take contiguous q, k, v (the kernels read raw row-major
    buffers); a head-split view of ``qkv`` is copied here, inside the graph."""
    return q.contiguous(), k.contiguous(), v.contiguous()


def _mean(q, k, lse, pad_interval, lib=None):
    """The mean pass: recompute the probabilities tile by tile from the
    flash pass's row statistic, sum the heads, write the mean once. The
    query tiles of all heads stay in shared memory up to
    ``lib.attn_mean_resident_heads(d)`` heads, and stream beside the keys
    above."""
    _require_contiguous("attention mean pass", q, k, lse)
    b, h, t, d = q.shape
    lib = forward_library() if lib is None else lib
    mean = torch.empty((b, t, t), device=q.device, dtype=q.dtype)
    lo, hi = _gap(t, pad_interval)
    err = lib.attn_mean_forward(q.data_ptr(), k.data_ptr(), lse.data_ptr(), mean.data_ptr(), b, h,
                                t, d, lo, hi, d**-0.5 * _LOG2E,
                                torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "attn_mean_forward")
    return mean


def attention_no_capture(q, k, v, pad_interval=None):
    """Attention without the probability output (the non-capture blocks)."""
    lo, hi = _gap(q.shape[2], pad_interval)
    return attention_plain_op(*_operands(q, k, v), lo, hi)[0]


def attention_with_capture(q, k, v, pad_interval=None):
    """Attention + head-averaged probabilities (B, T, T) in q.dtype, which
    carry no gradient.

    On the card: the flash pass writes ``out`` and each head's row
    log2-sum-exp, then the mean pass recomputes the probabilities tile by
    tile, sums the heads and writes the mean once.
    """
    lo, hi = _gap(q.shape[2], pad_interval)
    out, mean, _ = attention_capture_op(*_operands(q, k, v), lo, hi)
    return out, mean


def reduce_capture(mean_local, tp):
    """The head mean over all H heads from this rank's mean over its H / tp
    heads: the all-reduce of ``mean_local / tp`` over the model group ``tp``
    (a ``parallel.tp.TPContext``), one (B, T, T) tensor, summed in f32 and
    rounded once to the storage dtype (as the single-rank mean is rounded
    once)."""
    return all_reduce(mean_local.float() / tp.size, tp.group).to(mean_local.dtype)


def attention_with_capture_sharded(q, k, v, pad_interval=None, tp=None):
    """Capture attention on a head shard (the JAX package's
    ``attention_with_capture_sharded``).

    Under a model group ``tp`` of more than one rank, q, k, v hold this
    rank's H / tp heads (the column-parallel qkv's output): the capture op
    (kernel #1 on the card) runs on them, and the head-mean probabilities
    of all H heads are rebuilt with one all-reduce (``reduce_capture``).
    Otherwise this is exactly ``attention_with_capture``. The gradient goes
    through the op's registered backward (#5, #6) on the local heads."""
    out, mean = attention_with_capture(q, k, v, pad_interval)
    if tp is None or tp.size == 1:
        return out, mean
    return out, reduce_capture(mean, tp)


# plain attention on a head shard (the JAX package's name): heads are
# independent, so a rank runs ``attention_no_capture`` (kernel #2 on the
# card) on its H / tp heads as they are
attention_no_capture_sharded = attention_no_capture
