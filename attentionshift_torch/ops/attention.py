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
dK and dV; at head dim 32 and T <= 64 one kernel (``bwd32_short``,
``attention_backward_short``) gives all three in one pass. The row
normaliser of the recomputed probabilities is the forward's log2-sum-exp,
which the flash pass writes whenever a gradient may be asked for.

The kernels have instances for head dims 64 (the ViTs), 32 (Swin's
global blocks, the decoder heads) and 128, and a wide route for any
multiple of 128 above 128, which walks a head row as a run of 128-column
slabs (``flash_fwd_wide``, ``attn_mean_wide``, ``bwd_dq_wide``,
``bwd_dkv_wide``); they take any number of heads: the mean pass keeps
every head's query tile while they fit (``attn_mean_resident_heads``; the
wide route never) and streams them above that. Launches of the 32 and 128
instances and of the wide route are counted under their own names,
``<kernel>_d32``, ``<kernel>_d128`` and ``<kernel>_dwide``. On a CUDA
tensor the head dim d picks the route (``kernel_head_dim``), as the JAX
package's dispatch does: d divisible by 8 runs the smallest instance at
least as wide, or above 128 the wide route at 128 * ceil(d / 128), on q,
k, v zero-padded on the head axis, with the softmax scale of the true d,
and its outputs sliced back (zero columns change neither q k^T nor the
probabilities, so this is exact); d not divisible by 8 runs the plain
version, as the JAX package does, counted in ``PLAIN_ROUTE``. The forward
at head dim 32 has kernels of its own (``flash_fwd32``, ``flash_fwd32_short``
for T <= 64, ``attn_mean32``), whose launch plan the library picks and
``d32_plan`` mirrors; so does the backward (``bwd32_dq``, ``bwd32_dkv``,
``bwd32_short`` for T <= 64; ``d32_bwd_plan``), whose route
``backward_records`` names.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ..parallel.collectives import all_reduce
from ._build import KERNELS, check, library
from .numerics import F32_MIN_NORMAL, bf16_steps

__all__ = ["HEAD_DIMS", "SLAB", "PLAIN_ROUTE", "kernel_head_dim", "forward_on_instance",
           "backward_on_instance", "attention_reference", "attention_backward_reference",
           "attention_with_capture", "attention_no_capture", "attention_with_capture_sharded",
           "attention_no_capture_sharded", "reduce_capture", "attention_plain_op",
           "attention_capture_op", "attention_flops", "flash_forward", "forward_library",
           "attention_backward_dq", "attention_backward_dkv", "capture_mean_limit", "kernel_name",
           "pad_head", "d32_plan", "d32_smem", "kernel_d32_plan", "backward_library",
           "attention_backward_short", "backward_records", "d32_bwd_plan", "d32_bwd_smem",
           "kernel_d32_bwd_plan"]

_LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 32, 128)  # the head dims the kernels have instances for
SLAB = 128  # the wide route takes head dims that are multiples of SLAB above it
# calls a CUDA tensor made through the plain versions, chosen by a head dim
# not divisible by 8 (the JAX package's dispatch); no kernel launches there
PLAIN_ROUTE = {"attention_plain": 0, "attention_capture": 0, "attention_backward": 0}


def kernel_name(name: str, d: int) -> str:
    """The ``KERNELS`` record that counts ``name``'s launches on the
    instance of head dim ``d``: the name itself at 64, ``<name>_d<d>`` at 32
    and 128, ``<name>_dwide`` on the wide route (``d`` above 128)."""
    if d > SLAB:
        return f"{name}_dwide"
    return name if d == 64 else f"{name}_d{d}"


def kernel_head_dim(d: int) -> int | None:
    """The head dim ``d`` runs on: for ``d`` divisible by 8 the smallest of
    32, 64 and 128 at least ``d``, or above 128 the wide route's 128 *
    ceil(d / 128); None (the plain version) for any other ``d``, where the
    JAX package takes its plain path too
    (``attentionshift_tpu/ops/attention.py``, ``q.shape[-1] % 8``)."""
    if d % 8:
        return None
    for kd in sorted(HEAD_DIMS):
        if d <= kd:
            return kd
    return -(-d // SLAB) * SLAB


def _instance(d: int) -> bool:
    """Whether the kernels take head dim ``d`` as it is: 32, 64, 128, or a
    multiple of 128 above 128 (the wide route)."""
    return d in HEAD_DIMS or (d > SLAB and d % SLAB == 0)


def pad_head(x, kd: int):
    """``x`` zero-padded on its last (head) axis to ``kd`` columns."""
    return x if x.shape[-1] == kd else F.pad(x, (0, kd - x.shape[-1])).contiguous()


def forward_on_instance(forward, q, k, v, pad_interval=None):
    """``forward(q, k, v, pad_interval, head_dim)`` on q, k, v zero-padded
    on the head axis to their instance's head dim, ``head_dim`` the true
    d (whose d^-0.5 the softmax takes); the first output, (B, H, T, kd),
    is sliced back to d, the others are returned as they are."""
    d = q.shape[-1]
    kd = kernel_head_dim(d)
    out, *rest = forward(*(pad_head(x, kd) for x in (q, k, v)), pad_interval, d)
    return (out if kd == d else out[..., :d].contiguous(), *rest)


def backward_on_instance(backward, q, k, v, g_out, pad_interval=None):
    """``backward(q, k, v, g_out, pad_interval, head_dim)`` -> (dq, dk, dv)
    on inputs zero-padded as in ``forward_on_instance``, the gradients
    sliced back to d (a padded column of q or k meets only zero columns,
    so nothing is lost)."""
    d = q.shape[-1]
    kd = kernel_head_dim(d)
    grads = backward(*(pad_head(x, kd) for x in (q, k, v, g_out)), pad_interval, d)
    return tuple(g if kd == d else g[..., :d].contiguous() for g in grads)


def _logits(q, k, head_dim=None):
    """q k^T d^-0.5 in f32: the storage-dtype product, then the scale; d is
    ``head_dim``, else q's last axis."""
    d = q.shape[-1] if head_dim is None else head_dim
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5


def attention_reference(q, k, v, pad_interval=None, head_dim=None):
    """Plain version: (B, H, T, d) -> (out (B,H,T,d), mean (B,T,T)) in q.dtype.

    Logits and softmax in f32 from the storage-dtype operands (bf16 x bf16
    products are exact in f32, so this is the JAX ``preferred_element_type
    =f32`` contraction); probabilities are rounded to v's dtype for the
    PV product, as in the JAX package. The scale d^-0.5 multiplies the f32
    logits, as the kernels apply it: at head dim 64 (0.125, a power of
    two) that is bitwise what scaling q first gives; at 32 it leaves out a
    rounding of q * d^-0.5 to the storage dtype, which neither the kernels
    nor an f32 model make. ``head_dim`` (default: q's last axis) is the d
    of the scale, for inputs zero-padded on the head axis.
    """
    logits = _logits(q, k, head_dim)
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


def _check_inputs(q, k, v, instance: bool = True):
    """Device, dtype and shapes of the kernels' inputs; with ``instance``,
    a head dim the kernels have an instance for (the ops check the head dim
    of the inputs they pad through ``kernel_head_dim``)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention kernel: q, k, v must all be CUDA tensors")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention kernel: q/k/v shapes differ or are not 4-D: {tuple(q.shape)}")
    if instance and not _instance(q.shape[-1]):
        raise ValueError(f"attention kernel takes head dim {', '.join(map(str, HEAD_DIMS))} or a "
                         f"multiple of {SLAB} above {SLAB}, got {q.shape[-1]}")


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
        lib.attn_d32_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.attn_flash_forward, lib.attn_mean_forward, lib.attn_mean_resident_heads,
                   lib.attn_d32_plan):
            fn.restype = ctypes.c_int
    return lib


# The head-dim-32 forward (csrc/attention.cu: flash_fwd32, flash_fwd32_short,
# attn_mean32): its design constants as built, and a mirror of the host's
# plan (plan32), which the CPU tests check and chip_smoke.py holds against
# the library's own (``kernel_d32_plan``).
D32_FLASH_STAGES = 4  # F32_STAGES
D32_SHORT_STAGES = 2  # F32_SHORT_STAGES
D32_MEAN_WARPGROUPS = 4  # M32_WARPGROUPS
D32_MEAN_STAGES = 4  # M32_STAGES
MEAN_MAX_CHUNK = 16
MEAN_RESIDENT_BYTES = 16 * 8192
SMEM_LIMIT = 232448  # what a block may use on an H100 (227 KB)
_KV32 = 64 * 32 * 2  # one 64-row tile at d = 32
_TILE = 64
D32_KERNELS = ("flash_fwd32", "flash_fwd32_short", "attn_mean32<true>", "attn_mean32<false>")


def d32_smem(kernel: str, heads: int = 1) -> int:
    """Shared memory bytes of a d = 32 kernel as built (fwd32_smem,
    short32_smem, mean32_smem at ``heads`` heads)."""
    if kernel == "flash_fwd32":  # Q tiles, K/V slots, barriers (Q, arrived, free)
        return (2 + 2 * D32_FLASH_STAGES) * _KV32 + (1 + 2 * D32_FLASH_STAGES) * 8 + 1024
    if kernel == "flash_fwd32_short":
        return D32_SHORT_STAGES * 3 * _KV32 + 2 * D32_SHORT_STAGES * 8 + 1024
    resident = kernel == "attn_mean32<true>"
    ring = D32_MEAN_WARPGROUPS * D32_MEAN_STAGES * (1 if resident else 2) * _KV32
    return ((heads * _KV32 + heads * _TILE * 4) if resident else 0) + ring \
        + (1 + 2 * D32_MEAN_WARPGROUPS * D32_MEAN_STAGES) * 8 + 1024


def _mean32_chunk(ntiles: int, row_blocks: int, slots: int) -> int:
    best, best_cost = 1, None
    for c in range(1, min(ntiles, MEAN_MAX_CHUNK) + 1):
        blocks = row_blocks * -(-ntiles // c)
        cost = -(-blocks // slots) * (2 * -(-c // D32_MEAN_WARPGROUPS) + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def d32_plan(b: int, h: int, t: int, sms: int, per_sm) -> dict:
    """The host's plan of a d = 32 forward (csrc/attention.cu plan32) on a
    card of ``sms`` SMs whose blocks per SM ``per_sm(kernel, smem)`` gives
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor): T <= 64 takes
    ``flash_fwd32_short`` on min(planes, resident blocks) persistent blocks,
    else ``flash_fwd32`` on (ceil(T / 128), H, B); the mean pass keeps the
    query tiles while H x 4 KB <= MEAN_RESIDENT_BYTES and the block fits,
    with the chunk of key tiles of fewest, shortest waves."""
    flash = "flash_fwd32_short" if t <= _TILE else "flash_fwd32"
    fsmem = d32_smem(flash)
    fper = per_sm(flash, fsmem)
    fblocks = min(b * h, sms * fper) if t <= _TILE else -(-t // (2 * _TILE))
    res = h * _KV32 <= MEAN_RESIDENT_BYTES and d32_smem("attn_mean32<true>", h) <= SMEM_LIMIT
    mean = "attn_mean32<true>" if res else "attn_mean32<false>"
    msmem = d32_smem(mean, h)
    mper = per_sm(mean, msmem)
    ntiles = -(-t // _TILE)
    chunk = _mean32_chunk(ntiles, b * ntiles, sms * mper)
    return dict(flash=flash, flash_blocks=fblocks, flash_per_sm=fper, flash_smem=fsmem,
                mean=mean, mean_chunk=chunk, mean_chunks=-(-ntiles // chunk), mean_per_sm=mper,
                mean_smem=msmem, sms=sms)


# The head-dim-32 backward (csrc/attention_bwd.cu: bwd32_dq, bwd32_dkv,
# bwd32_short): its design constants as built, and a mirror of the host's
# plan (plan_b32), which the CPU tests check and chip_smoke.py holds against
# the library's own (``kernel_d32_bwd_plan``).
D32_BWD_STAGES = 3  # B32_STAGES
D32_BWD_SHORT_STAGES = 2  # B32_SHORT_STAGES
D32_BWD_KEPT_TILES = 4  # B32_PCACHE_TILES: bwd32_dq keeps p up to T = 256
SM_SMEM = 233472  # an SM's shared memory; each block also reserves 1 KB of it
D32_SHORT_T = _TILE  # the most tokens bwd32_short takes
D32_BWD_KERNELS = ("bwd32_dq", "bwd32_dq<kept>", "bwd32_dkv", "bwd32_short")


def d32_bwd_smem(kernel: str, t: int = 1) -> int:
    """Shared memory bytes of a d = 32 backward kernel (a name of
    ``D32_BWD_KERNELS``) as built at T = ``t`` (dq32_smem, dkv32_smem,
    short32_smem): two buffers of its own tiles, the ring, kept p (8 KB per
    key tile), the barriers."""
    if kernel == "bwd32_short":
        return 2 * 2 * _KV32 + D32_BWD_SHORT_STAGES * (4 * _KV32 + _TILE * 4) \
            + 2 * D32_BWD_SHORT_STAGES * 8 + 1024
    bars = (2 + D32_BWD_STAGES) * 8 + 1024
    if kernel == "bwd32_dkv":
        return 4 * _KV32 + D32_BWD_STAGES * (2 * _KV32 + 2 * _TILE * 4) + bars
    kept = -(-t // _TILE) if kernel == "bwd32_dq<kept>" else 0
    return 4 * _KV32 + D32_BWD_STAGES * 2 * _KV32 + kept * 2 * _KV32 + bars


def _d32_keeps(t: int) -> bool:
    """Whether bwd32_dq keeps p at T = ``t`` (dq32_keeps): at most
    D32_BWD_KEPT_TILES key tiles, three blocks per SM still resident."""
    return -(-t // _TILE) <= D32_BWD_KEPT_TILES and \
        (d32_bwd_smem("bwd32_dq<kept>", t) + 1024) * 3 <= SM_SMEM


def d32_bwd_plan(b: int, h: int, t: int, sms: int, per_sm) -> dict:
    """The host's plan of a d = 32 backward (csrc/attention_bwd.cu plan_b32)
    on a card of ``sms`` SMs whose blocks per SM ``per_sm(kernel, smem)``
    gives. T <= 64 takes ``bwd32_short`` (route "short"), else ``bwd32_dq``
    and ``bwd32_dkv`` (route "pair"). Each kernel's blocks walk units, as
    many blocks as are resident at once or fewer: ``bwd32_short`` planes,
    ``bwd32_dq`` query tiles (keeping p where it fits, T <= 256),
    ``bwd32_dkv`` key tiles (``units`` of them each)."""
    units = b * h * -(-t // _TILE)
    ssmem = d32_bwd_smem("bwd32_short")
    sper = per_sm("bwd32_short", ssmem)
    dq = "bwd32_dq<kept>" if _d32_keeps(t) else "bwd32_dq"
    dsmem, ksmem = d32_bwd_smem(dq, t), d32_bwd_smem("bwd32_dkv")
    dper, kper = per_sm(dq, dsmem), per_sm("bwd32_dkv", ksmem)
    return dict(route="short" if t <= D32_SHORT_T else "pair", short_blocks=min(b * h, sms * sper),
                short_per_sm=sper, short_smem=ssmem, dq=dq, units=units,
                dq_blocks=min(units, sms * dper), dq_per_sm=dper, dq_smem=dsmem,
                dkv_blocks=min(units, sms * kper), dkv_per_sm=kper, dkv_smem=ksmem, sms=sms)


def kernel_d32_bwd_plan(b: int, h: int, t: int, lib=None) -> dict:
    """The library's own plan (``attn_d32_bwd_plan``) in ``d32_bwd_plan``'s
    keys."""
    lib = backward_library() if lib is None else lib
    out = (ctypes.c_int * 13)()
    check(lib.attn_d32_bwd_plan(b, h, t, out), "attn_d32_bwd_plan")
    return dict(route="short" if out[0] else "pair", short_blocks=out[1], short_per_sm=out[2],
                short_smem=out[3], dq=D32_BWD_KERNELS[out[4]], units=out[12],
                dq_blocks=out[5], dq_per_sm=out[6], dq_smem=out[7], dkv_blocks=out[8],
                dkv_per_sm=out[9], dkv_smem=out[10], sms=out[11])


def backward_records(d: int, t: int) -> tuple:
    """The ``KERNELS`` records the ops' backward launches once each on the
    card at head dim ``d`` (the true d: its instance by ``kernel_head_dim``)
    and T = ``t``: ``attention_bwd_d32_short`` at head dim 32 and T <= 64,
    else pass A's and pass B's; none for a d the plain version takes."""
    kd = kernel_head_dim(d)
    if kd is None:
        return ()
    if kd == 32 and t <= D32_SHORT_T:
        return ("attention_bwd_d32_short",)
    return (kernel_name("attention_bwd_dq", kd), kernel_name("attention_bwd_dkv", kd))


def kernel_d32_plan(b: int, h: int, t: int, lib=None) -> dict:
    """The library's own plan (``attn_d32_plan``) in ``d32_plan``'s keys."""
    lib = forward_library() if lib is None else lib
    out = (ctypes.c_int * 10)()
    check(lib.attn_d32_plan(b, h, t, out), "attn_d32_plan")
    return dict(flash=D32_KERNELS[out[0]], flash_blocks=out[1], flash_per_sm=out[2],
                flash_smem=out[3], mean=D32_KERNELS[out[4]], mean_chunk=out[5],
                mean_chunks=out[6], mean_per_sm=out[7], mean_smem=out[8], sms=out[9])


def flash_forward(q, k, v, pad_interval, with_lse, lib=None, head_dim=None):
    """The flash pass on the card: (out, row log2-sum-exp (B, H, T) f32 or
    None), through ``lib`` (default: ``forward_library()``), the scale
    ``head_dim``^-0.5 (default: q's last axis). Counts no launch: the two
    attention ops do."""
    _require_contiguous("flash_forward", q, k, v)
    b, h, t, d = q.shape
    sd = d if head_dim is None else head_dim
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32) if with_lse else None
    lo, hi = _gap(t, pad_interval)
    lib = forward_library() if lib is None else lib
    err = lib.attn_flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 lse.data_ptr() if with_lse else None, b, h, t, d, lo, hi,
                                 sd**-0.5 * _LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "attn_flash_forward")
    return out, lse


def attention_backward_reference(q, k, v, g_out, pad_interval=None, head_dim=None):
    """Plain backward: (dq, dk, dv) of ``attention_reference``'s ``out``.

    The staged form of the JAX package: the recomputed probabilities and
    p * (dP - D) are rounded to the storage dtype before the products that
    consume them, every product accumulates in f32, D = sum_s p * dP. In
    f32 this is the exact softmax-attention gradient. Columns in the gap
    have p == 0, so their dk and dv are exactly zero. ``head_dim`` as in
    ``attention_reference``.
    """
    mm = q.dtype
    d = q.shape[-1] if head_dim is None else head_dim
    g = g_out.to(mm).float()
    logits = _logits(q, k, d)
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


def backward_library(defines=()):
    """``csrc/attention_bwd.cu``'s library (built with the ``-D`` overrides
    ``defines``), its entry points' signatures set."""
    lib = library("attention_bwd", defines)
    if lib.attn_d32_bwd_plan.argtypes is None:  # first use of this library
        lib.attn_backward_dq.argtypes = [ctypes.c_void_p] * 7 + _BWD_TAIL
        lib.attn_backward_dkv.argtypes = [ctypes.c_void_p] * 8 + _BWD_TAIL
        lib.attn_backward_short.argtypes = [ctypes.c_void_p] * 8 + _BWD_TAIL
        lib.attn_d32_bwd_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.attn_backward_dq, lib.attn_backward_dkv, lib.attn_backward_short,
                   lib.attn_d32_bwd_plan):
            fn.restype = ctypes.c_int
    return lib


def attention_backward_dq(q, k, v, lse, g_out, pad_interval=None, head_dim=None, lib=None):
    """Backward pass A on the card: (dq, D) with D = sum_s p * dP per row
    (B, H, T) f32, from ``flash_forward``'s row statistic. D is summed in
    f32 from the bf16 p, as the TPU kernel and ``attention_backward_reference``
    do. ``head_dim`` as in ``flash_forward``; ``lib``: ``backward_library()``
    by default."""
    _check_inputs(q, k, v)
    _require_contiguous("attention_backward_dq", q, k, v, lse, g_out)
    b, h, t, d = q.shape
    sd = d if head_dim is None else head_dim
    dq = torch.empty_like(q)
    dd = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    lo, hi = _gap(t, pad_interval)
    lib = backward_library() if lib is None else lib
    check(lib.attn_backward_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
                               lse.data_ptr(), dq.data_ptr(), dd.data_ptr(), b, h, t, d, lo, hi,
                               sd**-0.5 * _LOG2E, sd**-0.5,
                               torch.cuda.current_stream(q.device).cuda_stream),
          "attn_backward_dq")
    KERNELS[kernel_name("attention_bwd_dq", d)].launches += 1
    return dq, dd


def attention_backward_dkv(q, k, v, lse, dd, g_out, pad_interval=None, head_dim=None, lib=None):
    """Backward pass B on the card: (dk, dv), from the forward's row
    statistic and pass A's D. Gap columns come out exactly zero.
    ``head_dim`` and ``lib`` as in ``attention_backward_dq``."""
    _check_inputs(q, k, v)
    _require_contiguous("attention_backward_dkv", q, k, v, lse, dd, g_out)
    b, h, t, d = q.shape
    sd = d if head_dim is None else head_dim
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lo, hi = _gap(t, pad_interval)
    lib = backward_library() if lib is None else lib
    check(lib.attn_backward_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
                                lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
                                t, d, lo, hi, sd**-0.5 * _LOG2E, sd**-0.5,
                                torch.cuda.current_stream(q.device).cuda_stream),
          "attn_backward_dkv")
    KERNELS[kernel_name("attention_bwd_dkv", d)].launches += 1
    return dk, dv


def attention_backward_short(q, k, v, lse, g_out, pad_interval=None, head_dim=None, lib=None):
    """The whole backward on the card in one pass at head dim 32 and T <=
    64 (``bwd32_short``): (dq, dk, dv), the values of pass A and pass B
    (D summed in f32 from the bf16 p, gap columns of dk and dv exactly
    zero), with D kept on chip. ``head_dim`` and ``lib`` as in
    ``attention_backward_dq``."""
    _check_inputs(q, k, v)
    _require_contiguous("attention_backward_short", q, k, v, lse, g_out)
    b, h, t, d = q.shape
    if d != 32 or t > D32_SHORT_T:
        raise ValueError(f"attention_backward_short takes head dim 32 and T <= {D32_SHORT_T}, "
                         f"got {tuple(q.shape)}")
    sd = d if head_dim is None else head_dim
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lo, hi = _gap(t, pad_interval)
    lib = backward_library() if lib is None else lib
    check(lib.attn_backward_short(q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
                                  lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
                                  h, t, d, lo, hi, sd**-0.5 * _LOG2E, sd**-0.5,
                                  torch.cuda.current_stream(q.device).cuda_stream),
          "attn_backward_short")
    KERNELS["attention_bwd_d32_short"].launches += 1
    return dq, dk, dv


def _pad(lo: int, hi: int):
    """The custom ops' gap [lo, hi) as ``pad_interval`` (None when empty)."""
    return (lo, hi) if lo < hi else None


def _row_lse(q, k, pad_interval, head_dim=None):
    """The plain version of the flash pass's row log2-sum-exp (B, H, T) f32."""
    logits = _logits(q, k, head_dim)
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
    if kernel_head_dim(q.shape[-1]) is None:  # the JAX package's plain path, by d
        PLAIN_ROUTE["attention_plain"] += 1
        return attention_reference(q, k, v, _pad(lo, hi))[0], _row_lse(q, k, _pad(lo, hi))
    _check_inputs(q, k, v, instance=False)

    def launch(qp, kp, vp, pad_interval, head_dim):
        return flash_forward(qp, kp, vp, pad_interval, with_lse=True, head_dim=head_dim)

    out, lse = forward_on_instance(launch, q, k, v, _pad(lo, hi))
    KERNELS[kernel_name("attention_plain", kernel_head_dim(q.shape[-1]))].launches += 1
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
    if kernel_head_dim(q.shape[-1]) is None:  # the JAX package's plain path, by d
        PLAIN_ROUTE["attention_capture"] += 1
        out, mean = attention_reference(q, k, v, _pad(lo, hi))
        return out, mean, _row_lse(q, k, _pad(lo, hi))
    _check_inputs(q, k, v, instance=False)

    def launch(qp, kp, vp, pad_interval, head_dim):
        out, lse = flash_forward(qp, kp, vp, pad_interval, with_lse=True, head_dim=head_dim)
        return out, _mean(qp, kp, lse, pad_interval, head_dim=head_dim), lse

    out, mean, lse = forward_on_instance(launch, q, k, v, _pad(lo, hi))
    KERNELS[kernel_name("attention_capture", kernel_head_dim(q.shape[-1]))].launches += 1
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


def _backward_kernels(q, k, v, g_out, pad_interval, head_dim, lse):
    if q.shape[-1] == 32 and q.shape[2] <= D32_SHORT_T:  # one pass: bwd32_short
        return attention_backward_short(q, k, v, lse, g_out, pad_interval, head_dim=head_dim)
    dq, dd = attention_backward_dq(q, k, v, lse, g_out, pad_interval, head_dim=head_dim)
    return (dq, *attention_backward_dkv(q, k, v, lse, dd, g_out, pad_interval,
                                        head_dim=head_dim))


def _backward(ctx, g_out, *_):
    q, k, v, lse = ctx.saved_tensors
    if q.device.type == "cpu":
        grads = attention_backward_reference(q, k, v, g_out, ctx.pad_interval)
    elif kernel_head_dim(q.shape[-1]) is None:  # the JAX package's plain path, by d
        PLAIN_ROUTE["attention_backward"] += 1
        grads = attention_backward_reference(q, k, v, g_out, ctx.pad_interval)
    else:
        g_out = g_out.to(q.dtype).contiguous()
        grads = backward_on_instance(
            lambda *a: _backward_kernels(*a, lse=lse), q, k, v, g_out, ctx.pad_interval)
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


def _mean(q, k, lse, pad_interval, lib=None, head_dim=None):
    """The mean pass: recompute the probabilities tile by tile from the
    flash pass's row statistic, sum the heads, write the mean once. The
    query tiles of all heads stay in shared memory up to
    ``lib.attn_mean_resident_heads(d)`` heads, and stream beside the keys
    above. ``head_dim`` as in ``flash_forward``."""
    _require_contiguous("attention mean pass", q, k, lse)
    b, h, t, d = q.shape
    sd = d if head_dim is None else head_dim
    lib = forward_library() if lib is None else lib
    mean = torch.empty((b, t, t), device=q.device, dtype=q.dtype)
    lo, hi = _gap(t, pad_interval)
    err = lib.attn_mean_forward(q.data_ptr(), k.data_ptr(), lse.data_ptr(), mean.data_ptr(), b, h,
                                t, d, lo, hi, sd**-0.5 * _LOG2E,
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
