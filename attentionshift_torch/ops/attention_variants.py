"""Design variants of the capture-attention forward.

Port of the five experimental kernels of the JAX package's attention
microbenchmark (``tools/analysis/microbench_attention.py``, ``v2`` ...
``v6``). Each takes q, k, v (B, H, T, d) and returns

    out  (B, H, T, d)    softmax(q k^T / sqrt(d)) v per head
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
                 (the sum over heads, then one division by H)
    v6-fusedsum  v2 with the row sum folded into PV: V gets 8 all-ones
                 columns and the denominator is column d of the product

``attention_variant`` is the wrapper: a CPU tensor takes the plain
PyTorch version ``variant_reference``, which repeats the variant's
arithmetic step by step; a CUDA tensor launches the hand-written kernel
in ``csrc/attention_variants.cu`` or raises. There is no fallback
between the two, and no gradient: the variants are forward experiments.
v2, v3, v4 and v6 run two kernels per call (an out pass that also writes
each row's reciprocal row sum into a (B, H, T) f32 workspace, then a mean
pass that reads it), counted as one launch, as the capture pair of
``ops/attention.py`` is. v5 is one kernel on a thread block cluster
(``attn_v5_cluster`` says how many blocks): each block writes ``out`` of
whole heads, then the mean of its share of the key range; it keeps the
recips in shared memory and needs the workspace only above 24 heads.
``mean_limit`` is the per-entry limit the card checks hold a kernel's
mean to.

The kernels have instances for head dims 32, 64 and 128
(``VARIANT_HEAD_DIMS``), launches of the 32 and 128 instances counted
under ``<kernel>_d32`` and ``<kernel>_d128``. Above 128 every variant
runs on the wide route at 128 * ceil(d / 128) (``csrc/attention_variants.cu``),
counted under ``<kernel>_dwide``: TMA rings and wgmma, S computed once per
key tile for every 128-column output slab a block holds (up to three), v5
one launch on thread block clusters; ``wide_variant_plan`` mirrors the
host's plan of its three kernels (``kernel_wide_plan`` reads the
library's). Any other d runs
on the smallest instance at least as wide, on q, k, v zero-padded on the
head axis, with the scale of the true d (the JAX tool's kernels take any
``--dim``, also one not divisible by 8); v6's 8 ones columns then follow
the padded width. ``out`` is sliced back to d. Zero columns change
neither q k^T nor the row sums, so the padding is exact.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KERNELS, check, library
from .attention import kernel_name, pad_head
from .numerics import F32_MIN_NORMAL, bf16_steps

__all__ = ["VARIANTS", "VARIANT_HEAD_DIMS", "variant_head_dim", "variant_kernel",
           "variant_reference", "attention_variant", "variant_library", "clamp_case", "mean_limit",
           "wide_variant_plan", "kernel_wide_plan", "WIDE_PLAN_KEYS", "SMEM_LIMIT"]

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
VARIANT_HEAD_DIMS = (32, 64, 128)  # the head dims the variant kernels have instances for


def variant_head_dim(d: int) -> int:
    """The instance head dim ``d`` runs on: the smallest of 32, 64 and 128
    at least ``d``, or above 128 the wide route's 128 * ceil(d / 128)."""
    for kd in VARIANT_HEAD_DIMS:
        if d <= kd:
            return kd
    return -(-d // VARIANT_HEAD_DIMS[-1]) * VARIANT_HEAD_DIMS[-1]


def variant_kernel(variant: str, kd: int) -> str:
    """The ``KERNELS`` record that counts ``variant``'s launches on the
    instance of head dim ``kd``, named as ``attention.kernel_name`` names
    the attention kernels' records."""
    return kernel_name(VARIANTS[variant][0], kd)


def _q_scale(q):
    """d^-0.5 * log2(e) rounded to q's dtype, as the TPU kernels fold it
    into the query tile (a 0-dim CPU tensor: no device read to get its value)."""
    return torch.tensor(q.shape[-1] ** -0.5 * _LOG2E, dtype=q.dtype)


def _with_ones(v):
    """V with 8 all-ones columns appended: (B, H, T, d + 8)."""
    return torch.cat([v, v.new_ones((*v.shape[:-1], 8))], dim=-1)


def _logits(q, k):
    """The shifted log2 logits (B, H, T, T) f32: q times the scale rounded
    to the storage dtype, times k^T in f32, minus 20."""
    qs = q * _q_scale(q)
    return torch.matmul(qs.float(), k.float().transpose(-1, -2)) - _SOFTMAX_SHIFT


def variant_reference(q, k, v, variant: str):
    """Plain version of one variant: (out (B,H,T,d), mean (B,T,T)) in
    q.dtype."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown attention variant {variant!r}; known: {sorted(VARIANTS)}")
    b, h, t, d = q.shape
    logits = _logits(q, k)
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
    variant_head_dim(q.shape[-1])
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("attention variant kernel: q, k, v must all be CUDA tensors")


def variant_library(defines=()):
    """``csrc/attention_variants.cu``'s library (built with the ``-D``
    overrides ``defines``), its entry point's signature set."""
    lib = library("attention_variants", defines)
    fn = lib.attn_variant_forward
    if fn.argtypes is None:  # first use of this library
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        lib.attn_v5_cluster.restype = ctypes.c_int
        lib.attn_v5_cluster.argtypes = [ctypes.c_int] * 4
        lib.attn_wide_plan.restype = ctypes.c_int
        lib.attn_wide_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


# The wide route's design constants (csrc/attention_variants.cu), for the
# plan's mirror. A slab is 64 rows of 128 bf16 columns.
_SLAB = 64 * 128 * 2
_TILE_BYTES = 64 * 64 * 2  # an e tile
_ONES_BYTES = 1024  # v4's ones operand
_COLS_BYTES = 64 * 16  # v6's column box
_W_MAX_WARPGROUPS = 3  # out pass: consumer warpgroups (slabs) a block, at most
_W_E_SLOTS = 2  # out pass: e tiles
_W_MIN_SLOTS = 4  # out pass: fewer ring slots beside a resident Q: Q streams
_W_MAX_SLOTS = 16
_WM_ROWS = 2  # mean pass: query row tiles a block
_WM_SLOTS = 2
_WM_BLOCKS_PER_SM = 2
_WM_MAX_CHUNK = 16  # mean pass: key tiles a block, at most
_W5_SLOTS = 2  # v5's sweep 2: ring entries a lane
_W5_MAX_CLUSTER = 4  # v5: blocks a cluster, at most
W_PRODUCER = 32  # the producer warp of every wide kernel
SMEM_LIMIT = 232448  # shared memory a block may use
_W_ALIGN = 1024
_W_TAIL = _W_MAX_WARPGROUPS * 64 * 4 + 512  # row sums, barriers
WIDE_PLAN_KEYS = ("sms", "slabs", "groups", "qstream", "slots", "out_smem", "out_x", "out_y",
                  "out_z", "chunk", "mean_smem", "mean_x", "mean_y", "mean_z", "cluster", "lanes",
                  "v5_smem", "v5_x", "v5_y", "v5_z")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _mean_chunk(ntiles: int, row_blocks: int, slots: int, max_chunk: int) -> int:
    """Key tiles per mean-pass block (the source's ``mean_chunk``): the
    fewest waves of ``slots`` resident blocks times a block's cost (its
    chunk plus half a tile for its query tiles); ties to the shorter."""
    best, best_cost = 1, -1
    for c in range(1, min(ntiles, max_chunk) + 1):
        cost = _ceil(row_blocks * _ceil(ntiles, c), slots) * (2 * c + 1)
        if best_cost < 0 or cost < best_cost:
            best, best_cost = c, cost
    return best


def _wide_shape(ns: int, number: int) -> dict:
    """The out pass's block at ``ns`` slabs for variant ``number`` (the
    source's ``wide_shape``): slabs (= consumer warpgroups; three and the
    producer warp leave 128 registers a thread, four 96, where the products
    serialize) in ``ceil(ns / 3)`` groups, whether Q streams through the
    ring (where a resident Q leaves fewer than four slots), ring slots, and
    shared memory."""
    slabs = _ceil(ns, _ceil(ns, _W_MAX_WARPGROUPS))
    slot = _SLAB + (_COLS_BYTES if number == 6 else 0)
    for qstream in (0, 1):
        fixed = ((0 if qstream else ns * _SLAB) + _W_E_SLOTS * _TILE_BYTES
                 + (_ONES_BYTES if number == 4 else 0))
        room = int((SMEM_LIMIT - _W_ALIGN - _W_TAIL - fixed) / slot)  # toward zero, as C divides
        slots = min(room, _W_MAX_SLOTS)
        region = fixed + slots * slot
        if slots >= _W_MIN_SLOTS:
            break
    return dict(slabs=slabs, groups=_ceil(ns, slabs), qstream=qstream, slots=slots, region=region,
                smem=_W_ALIGN + region + _W_TAIL)


def wide_variant_plan(b: int, h: int, t: int, kd: int, variant, sms: int) -> dict:
    """The host's plan of the wide route (``wide_plan`` in
    ``csrc/attention_variants.cu``) at (B, H, T, KD) for ``variant`` (a
    name of ``VARIANTS`` or its number) on ``sms`` SMs, in
    ``WIDE_PLAN_KEYS``:

    - out pass (v2, v3, v4, v6): ``slabs`` consumer
      warpgroups and a producer warp a block, grid (``out_x`` query tiles of
      64 rows, ``out_y`` = ``groups`` slab groups, ``out_z`` = B H planes); S
      is computed once per key tile and group; ``slots`` 16 KB ring slots
      (v6: 17 KB), ``qstream`` 1 where Q streams through them, ``out_smem``
      bytes;
    - mean pass: two warpgroups (128 query rows) and a producer warp a
      block, two blocks per SM, grid (``mean_x`` chunks of ``chunk`` key
      tiles, ``mean_y`` row pairs, ``mean_z`` = B), two ring entries,
      ``mean_smem``;
    - v5: clusters of ``cluster`` blocks, grid (``v5_x`` = cluster,
      ``v5_y`` query tiles, ``v5_z`` = B), the out pass's block for sweep
      1, ``lanes`` warpgroups with two ring entries each for sweep 2,
      ``v5_smem``."""
    number = VARIANTS[variant][1] if isinstance(variant, str) else int(variant)
    ns, nk = kd // 128, _ceil(t, 64)
    s = _wide_shape(ns, number)
    pairs = _ceil(t, _WM_ROWS * 64)
    chunk = _mean_chunk(nk, b * pairs, sms * _WM_BLOCKS_PER_SM, _WM_MAX_CHUNK)
    f = _wide_shape(ns, 2)  # v5's sweep 1 has v2's arithmetic
    lanes = min(f["slabs"], f["region"] // (_W5_SLOTS * 2 * _SLAB))
    best, cluster = -1, 1
    for c in range(1, min(_W5_MAX_CLUSTER, nk) + 1):
        waves = _ceil(b * nk, max(sms // c, 1))
        s1 = _ceil(h, c) * f["groups"] * nk * (ns + f["slabs"])
        s2 = h * _ceil(_ceil(nk, c), lanes) * ns * f["slabs"]
        if best < 0 or waves * (s1 + s2) < best:
            best, cluster = waves * (s1 + s2), c
    plan = dict(sms=sms, slabs=s["slabs"], groups=s["groups"], qstream=s["qstream"],
                slots=s["slots"], out_smem=s["smem"], out_x=nk, out_y=s["groups"], out_z=b * h,
                chunk=chunk, mean_smem=_W_ALIGN + _WM_SLOTS * (1 + _WM_ROWS) * _SLAB + _W_TAIL,
                mean_x=_ceil(nk, chunk), mean_y=pairs, mean_z=b, cluster=cluster, lanes=lanes,
                v5_smem=f["smem"], v5_x=cluster, v5_y=nk, v5_z=b)
    return {k: plan[k] for k in WIDE_PLAN_KEYS}


def kernel_wide_plan(b: int, h: int, t: int, kd: int, variant, lib=None) -> dict:
    """The library's own plan (``attn_wide_plan``, on the current device)
    in ``wide_variant_plan``'s keys."""
    number = VARIANTS[variant][1] if isinstance(variant, str) else int(variant)
    lib = variant_library() if lib is None else lib
    out = (ctypes.c_int * len(WIDE_PLAN_KEYS))()
    check(lib.attn_wide_plan(b, h, t, kd, number, out), "attn_wide_plan")
    return dict(zip(WIDE_PLAN_KEYS, out))


def _workspace(q):
    """The (B, H, T) f32 workspace of each row's reciprocal row sum: from
    the out pass to the mean pass (v2, v3, v4, v6); v5 writes it at d <= 128
    only above 24 heads, where its recips leave shared memory, and on the
    wide route always (its ranks pass their recips through it)."""
    b, h, t, _ = q.shape
    return torch.empty((b, h, t), device=q.device, dtype=torch.float32)


def _launch(fn, variant, q, k, v, stream):
    """One call of ``attn_variant_forward`` (``fn``) on contiguous inputs
    on ``stream``: (out, mean), one launch counted. q, k, v are zero-padded
    on the head axis to their instance's head dim (v6's ones after the
    padded width), the scale is the true d's, ``out`` is sliced back."""
    _, number = VARIANTS[variant]
    b, h, t, d = q.shape
    kd = variant_head_dim(d)
    qp, kp, vp = (pad_head(x, kd) for x in (q, k, v))
    vp = _with_ones(vp) if variant == "v6-fusedsum" else vp
    out = torch.empty_like(qp)
    mean = torch.empty((b, t, t), device=q.device, dtype=q.dtype)
    work = _workspace(q)
    check(fn(number, qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), mean.data_ptr(),
             work.data_ptr(), b, h, t, kd, float(_q_scale(q)), stream),
          f"attn_variant_forward({variant})")
    KERNELS[variant_kernel(variant, kd)].launches += 1
    return (out if kd == d else out[..., :d].contiguous()), mean


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


# the clamp input: query row, the two key columns, the query value and the
# two shifted log2 logits aimed at; q.k * bf16(scale) = d * 4 * bf16(scale) *
# key value, each key value rounded to bf16 (at d = 64: bf16(0.125 log2 e)
# = 185/1024, key values 2.8125 and 2.6875, logits 110.08 and 104.30)
_CLAMP_ROW, _CLAMP_COLS = 3, (5, 9)
_CLAMP_Q = 4.0
_CLAMP_LOGITS = (110.08, 104.30)


def clamp_case(q, k, v):
    """Copies of q, k, v (any head dim d) in which query row 3 of every head
    has two shifted log2 logits inside (100, 127): about 110 at key 5 and
    about 104 at key 9, every other logit of the row far below. The
    clamped variants give both keys e = 2^100, so that row of ``out`` is
    the even mix of their values; v3 keeps 2^110 and 2^104, a 55:1 mix."""
    q, k, v = q.clone(), k.clone(), v.clone()
    d = q.shape[-1]
    q[:, :, _CLAMP_ROW] = _CLAMP_Q
    step = d * _CLAMP_Q * float(_q_scale(q))
    for col, logit in zip(_CLAMP_COLS, _CLAMP_LOGITS):
        k[:, :, col] = float(torch.tensor((logit + _SOFTMAX_SHIFT) / step).bfloat16())
    return q, k, v


MEAN_LIMIT_STEPS = 5.5


def mean_limit(q, k, variant: str, want_mean):
    """Per-entry limit (B, T, T) f32 of a kernel's mean against the plain
    version's ``want_mean`` on the same q, k: 5.5 bf16 steps of each entry
    (``bf16_steps``), plus a floor on the rows where the kernel's exp2 can
    flush an e that the plain version keeps.

    Derivation. An entry is x = sum_h e_h * r_h / H, every term positive
    (r_h: 1 / head h's row sum), added in the same order in f32 on both
    sides; the two differ only in e and in the row sums.

    1. The kernel's logits (tensor-core sums) differ from the plain f32
       matmul's in the last bits, and ex2.approx from torch.exp2 by an f32
       ulp or two: e before its bf16 rounding moves by about 2^-17 of
       itself, so the rounded e moves by at most one bf16 step, which is
       2^-8 to 2^-7 of e (by where e lies in its binade): at most 2^-7.
    2. A row sum adds such e, all positive, so it moves by at most 2^-7 of
       itself, plus its summation order (at most T * 2^-24 of itself,
       2^-12 at T = 4352).
    3. So each head's term e_h * r_h moves by less than (1 + 2^-7) /
       (1 - 2^-7 - 2^-12) - 1 < 2^-6 + 2^-10 of itself (the f32 roundings
       of the products and sums add about (H + 2) * 2^-24, inside that),
       and the entry, a sum of positive terms, by less than that of itself.
    4. Let u be the bf16 step at x (x in [2^k, 2^(k+1)): u = 2^(k-7), x <
       2^8 u). The f32 entries differ by less than (2^-6 + 2^-10) * 2^8 u
       = 4.25 u. The stores round each to bf16: half a step at x, and at
       most a step at the kernel's entry (it may lie in the next binade).
       So the stored entries differ by less than 5.75 u; both lie above
       2^(k-1), where bf16 numbers are u / 2 apart, so by at most 5.5 u,
       and u is at most the step at the stored plain entry. Below 2^-126
       the step is 2^-133 and the same count holds.
    5. ex2.approx.ftz returns 0 where exp2 is subnormal (a shifted log2
       logit below -126, after the clamp); the plain version keeps that e
       (< 2^-126). On a row where that happens an entry can lose up to
       sum_h 2^-126 * r_h / H: that floor is added to the row's limit, and
       only there.

    v5 divides the same positive sum by H once; the limit holds for every
    variant."""
    b, h, t, _ = q.shape
    limit = MEAN_LIMIT_STEPS * bf16_steps(want_mean)
    s = _logits(q, k)
    if variant != "v3-nomin":
        s = s.clamp(max=100.0)
    flushed = (s < -126.0).any(dim=-1)  # (B, H, T)
    if bool(flushed.any()):
        recip = 1.0 / torch.exp2(s).to(torch.bfloat16).float().sum(dim=-1).clamp_min(1e-30)
        floor = (F32_MIN_NORMAL * recip * flushed).sum(dim=1) / h  # (B, T)
        limit = limit + floor[..., None]
    return limit
