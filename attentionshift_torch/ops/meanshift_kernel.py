"""Cosine mean-shift fixpoint (Stage C).

Port of ``attentionshift_tpu/ops/meanshift_kernel.py`` and of the plain
``cosine_shift_batch`` it replaces (``pseudo/meanshift.py:49-123``).
``cosine_shift_fixpoint`` is the wrapper: a CPU tensor takes the plain
version ``cosine_shift_batch``, a CUDA tensor launches
``csrc/meanshift.cu`` or raises. Up to ``CLUSTER_MAX_K`` = 32 prototypes
it runs the cluster kernel (record ``meanshift_fixpoint``); the host picks
its cluster size, tiles per block and ring slots (``_plan``) from the
shape and from how many clusters the card holds at once. Above 32 it runs
the second route (record ``meanshift_fixpoint_kwide``): a short chain of
kernels per iteration with the (G, K, N) similarities in device memory, at
any K and D, four launches per iteration; only its two products depend on
the operand type: with bf16 operands they run on the tensor cores (the
host's plan is ``kwide_plan``), with f32 operands on scalar FMAs. With
bf16 operands both routes
zero-pad D to a multiple of 16 (exact: zero columns add nothing to a dot
product or a norm, and the update keeps them zero) and slice the
prototypes back.

Numerics (both versions): cosine denominators ``max(|a|, 1e-8) *
max(|b|, 1e-8)``; log-softmax over N of ``sim / (temp * tau)``; the hard
assignment is torch's argmax over K (first maximum wins); dot operands
are rounded to ``matmul_dtype`` with f32 accumulation, the final
similarity against the unmasked features included (as the TPU kernel
does); everything else is f32.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KERNELS, check, library
from .attention import pad_head
from .numerics import bf16_steps

__all__ = ["CLUSTER_MAX_K", "cosine_shift_batch", "cosine_shift_fixpoint", "fixpoint_verdict",
           "instance_deviation", "kernel_kwide_plan", "kwide_plan", "kwide_work_floats",
           "one_step_limit", "reordered_witnesses", "route"]

_SMEM_LIMIT = 227 * 1024
CLUSTER_MAX_K = 32  # the cluster kernel's largest K (its KP instances 8, 16, 24, 32)
# as in csrc/meanshift.cu: cluster sizes the host may take, ring slots per
# warpgroup, parts of a row in a reduction over features
_CLUSTERS = (2, 3, 4, 5, 6, 7, 8)
_MAX_CLUSTER = 16  # non-portable: taken only when no portable size fits
_WARPGROUPS = 4
_MAX_STAGES = 2
_ROUND_BOXES = 3
_ROW_PARTS = 4
# as in csrc/meanshift.cu, the second route with bf16 operands: prototypes
# per chunk (one m64n64k16 product's N), consumer warpgroups and ring slots
# of kwt_sim and kwt_update, bytes of one (64, 64) bf16 box
KWIDE_CHUNK = 64
KWIDE_SIM_WARPGROUPS = 2
KWIDE_SIM_STAGES = 3
KWIDE_UPDATE_WARPGROUPS = 4
KWIDE_UPDATE_STAGES = 3
_BOX = 8192


def _acc(x: torch.Tensor) -> torch.dtype:
    """The plain version's accumulation type: f64 for f64 inputs, else f32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _mm(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round a dot operand to ``dtype`` and back to the accumulation type
    (exact products)."""
    acc = _acc(x)
    x = x.to(acc)
    return x if dtype in (None, torch.float32) else x.to(dtype).to(acc)


def _dot(a, b, dtype, tensor_cores: bool):
    """a @ b of operands rounded to ``dtype``: exact products summed in the
    accumulation type, or with ``tensor_cores`` the rounded operands
    multiplied on the card's tensor cores into f32, as the kernel's wgmma
    products are (batched (G, M, K) x (G, K, N))."""
    if tensor_cores:
        return torch.bmm(a.to(dtype), b.to(dtype), out_dtype=torch.float32)
    return torch.matmul(_mm(a, dtype), _mm(b, dtype))


def cosine_shift_batch(prototypes, feats, feats_org, tau=0.1, temp=0.1, n_shift=10,
                       matmul_dtype=None, tensor_cores=False):
    """Plain version. prototypes (G, K, D), feats (G, N, D) box-masked,
    feats_org (N, D) -> prototypes (G, K, D) f32, sim (G, K, N) f32; f64
    inputs accumulate in f64 and give f64 (the same operand rounding to
    ``matmul_dtype``), a reference free of f32 summation noise.
    ``tensor_cores`` (CUDA tensors, bf16 operands): every product on the
    tensor cores, the kernel's own rounding of its sums (a witness of
    ``fixpoint_verdict``)."""
    g, k, d = prototypes.shape
    acc = _acc(prototypes)
    tc = bool(tensor_cores) and matmul_dtype not in (None, torch.float32) and prototypes.is_cuda
    nb = feats.to(acc).norm(dim=-1).clamp_min(1e-8)  # (G, N)
    fm = feats if tc else _mm(feats, matmul_dtype)

    def cos_feats(prot):
        num = _dot(prot, fm.transpose(1, 2), matmul_dtype, tc)
        na = prot.norm(dim=-1).clamp_min(1e-8)
        return num / (na[..., None] * nb[:, None, :])

    prot = prototypes.to(acc)
    tau_arr = torch.full((g, k, 1), float(tau), device=prot.device, dtype=acc)
    kk = torch.arange(k, device=prot.device)[None, :, None]
    for _ in range(n_shift):
        sim = cos_feats(prot)
        scaled = sim / (temp * tau_arr)
        logw = scaled - torch.logsumexp(scaled, dim=-1, keepdim=True)
        weight = torch.exp(logw)
        mask_w = (kk == torch.argmax(logw, dim=1, keepdim=True)).float()
        prot = _dot(weight * mask_w, fm, matmul_dtype, tc)
        sim2 = cos_feats(prot)
        cnt = mask_w.sum(-1)
        dens = (sim2 * mask_w).sum(-1)
        dens = 1.0 - torch.where(cnt >= 1, dens / cnt.clamp_min(1.0), torch.zeros_like(dens))
        tau_arr = dens.clamp_min(1e-10)[..., None]
    num = _dot(prot, feats_org.T.expand(g, d, -1), matmul_dtype, tc)
    na = prot.norm(dim=-1).clamp_min(1e-8)
    nbo = feats_org.to(acc).norm(dim=-1).clamp_min(1e-8)
    return prot, num / (na[..., None] * nbo)


def one_step_limit(prototypes, box_mask, f, tau=0.1, temp=0.1, matmul_dtype=None):
    """Per-entry limits of one iteration (``n_shift`` 1) of a kernel against
    the plain version on the same inputs: (prototypes (G, K, D), sim
    (G, K, N)), f32.

    Derivation. The two compute the same first similarities but for the
    order of their D-term f32 sums: a cosine moves by at most
    D 2^-24 (its terms' magnitudes sum to at most 1), so each logit
    sim / (temp * tau) by at most eps = D 2^-24 / (temp * tau), each log
    weight (the logit less its log-sum-exp) by at most 2 eps, and each
    weight w (the hard assignment over K applied) by at most
    (e^(2 eps) - 1) w, under 3 eps w.
    1. The update is sum_n w_n f_n with the weights rounded to
       ``matmul_dtype``: in bf16 a weight may land one bf16 step apart
       (``bf16_steps``: 2^-8 to 2^-7 of it), so each prototype component
       moves by at most L_d = sum_n (step(w_n) + (3 eps + 2^-14) w_n)
       |f_nd| (in f32 without the step; 2^-14 for the N-term sum). Where a
       few features hold most of a prototype's weight (nearly parallel
       features, as a path's own inputs have) one such step is most of L.
    2. The similarity rounds the prototype to the operand type again (one
       more step of each component), sums D products in f32 (at most
       D 2^-24 < 2^-14 of the sum of their magnitudes for D <= 1024) and
       divides by the prototype's norm, which moves by at most |L|:
       |d sim_kn| <= sum_d (L_d + step(p_d) + 2^-14 |p_d|) |f_nd| /
       (|p| |f_n|) + |sim_kn| |L| / |p|, and never more than 2 (both are
       cosines).
    3. Where a feature's two best prototypes are within 4 eps in log
       weight (a near-tie of the hard assignment), the feature may go to
       either: each of the two may gain or lose its whole weight, w_kn
       |f_n| more in L. An exact tie (equal prototypes give equal sums in
       either) goes to the first on both.
    ``prototypes`` are the iteration's inputs, ``box_mask`` and ``f`` as
    ``cosine_shift_fixpoint`` takes them."""
    feats = f.float()[None] * box_mask.float()[..., None]
    g, k, d = prototypes.shape
    nb = feats.norm(dim=-1).clamp_min(1e-8)
    fm = _mm(feats, matmul_dtype)
    prot = prototypes.float()
    sim = torch.matmul(_mm(prot, matmul_dtype), fm.transpose(1, 2)) / (
        prot.norm(dim=-1).clamp_min(1e-8)[..., None] * nb[:, None, :])
    logw = torch.log_softmax(sim / (temp * tau), dim=-1)
    kk = torch.arange(k, device=prot.device)[None, :, None]
    w_all = torch.exp(logw)
    w = w_all * (kk == torch.argmax(logw, dim=1, keepdim=True))
    top2 = torch.topk(logw, 2, dim=1)  # the two best prototypes of each feature
    eps = d * 2.0**-24 / (temp * tau)  # a logit's reach under another summation order
    gap = top2.values[:, 0] - top2.values[:, 1]
    tie = ((gap > 0) & (gap < 4 * eps))[:, None, :]  # an exact tie resolves alike
    movable = torch.zeros_like(logw, dtype=torch.bool).scatter_(1, top2.indices, True) & tie
    bf16 = matmul_dtype not in (None, torch.float32)
    step = (lambda x: bf16_steps(x) * (x != 0)) if bf16 else (lambda x: torch.zeros_like(x))
    lim_p = torch.matmul(step(w) + w * (3 * eps + 2.0**-14) + w_all * movable, fm.abs())
    new = torch.matmul(_mm(w, matmul_dtype), fm)
    na = new.norm(dim=-1).clamp_min(1e-8)
    fo = _mm(f, matmul_dtype).abs()
    nbo = f.float().norm(dim=-1).clamp_min(1e-8)
    num = torch.matmul(lim_p + step(new) + new.abs() * 2.0**-14, fo.T)  # (G, K, N)
    new_sim = torch.matmul(_mm(new, matmul_dtype), _mm(f, matmul_dtype).T) / (na[..., None] * nbo)
    lim_s = num / (na[..., None] * nbo) + new_sim.abs() * (lim_p.norm(dim=-1) / na)[..., None]
    return lim_p, lim_s.clamp_max(2.0)


def instance_deviation(a, b) -> torch.Tensor:
    """(G,) f64 on the host: per instance, the largest difference of the
    prototypes of ``a`` and ``b`` over the largest |entry| of the
    instance's prototypes in ``b``, or that of the similarities, whichever
    is larger. ``a``, ``b``: (prototypes (G, K, D), sim (G, K, N))."""
    pa, pb = a[0].double(), b[0].double()
    scale = pb.abs().amax(dim=(1, 2))
    scale = torch.maximum(scale, 1e-6 * scale.max()).clamp_min(1e-30)
    dp = (pa - pb).abs().amax(dim=(1, 2)) / scale
    ds = (a[1].double() - b[1].double()).abs().amax(dim=(1, 2))
    return torch.maximum(dp, ds).cpu()


def reordered_witnesses(prototypes, box_mask, f, tau=0.1, temp=0.1, n_shift=10,
                        matmul_dtype=None, orders=8, seed=0, f64=True):
    """The plain version of the fixpoint with its sums in other orders: once
    accumulating in f64 (``f64``), and ``orders`` times in f32 over the
    features (N) and the feature dims (D) in a random order drawn from
    ``seed``, each result put back in the given order; with bf16 operands
    on the card every second one multiplies on the tensor cores, as the
    kernel does (``cosine_shift_batch(tensor_cores=True)``). Same operand
    rounding to ``matmul_dtype``, so each is as right as the plain version;
    their spread is how far the fixpoint on these inputs moves under
    rounding alone. Returns a list of (prototypes, sim)."""
    n, d = f.shape
    mask = box_mask.float()

    def plain(p, m, ff, tc=False):
        return cosine_shift_batch(p, ff[None] * m[..., None], ff, tau=tau, temp=temp,
                                  n_shift=n_shift, matmul_dtype=matmul_dtype, tensor_cores=tc)

    out = [plain(prototypes.double(), mask.double(), f.double())] if f64 else []
    gen = torch.Generator().manual_seed(seed)
    for j in range(orders):
        pn = torch.randperm(n, generator=gen).to(f.device)
        pd = torch.randperm(d, generator=gen).to(f.device)
        prot, sim = plain(prototypes.float()[..., pd], mask[:, pn], f.float()[pn][:, pd],
                          tc=j % 2 == 1)
        out.append((prot[..., torch.argsort(pd)], sim[..., torch.argsort(pn)]))
    return out


def fixpoint_verdict(results, prototypes, box_mask, f, floor, tau=0.1, temp=0.1, n_shift=10,
                     matmul_dtype=None, orders=8, max_orders=64) -> list:
    """Fixpoints ``results`` (a list of (prototypes, sim), a kernel's first)
    against the plain version on the same inputs, per instance
    (``instance_deviation``), with the plain version's own reordered sums
    as witnesses (``reordered_witnesses``: f64, then batches of ``orders``
    orders, drawn until every instance of the first result passes or
    ``max_orders`` are drawn; every result is judged by all of them).

    An instance passes when the result is within max(``floor``, 2 x the
    witnesses' largest deviation from the plain version), or within
    ``floor`` of one witness. Where the fixpoint is ill-conditioned
    (nearly parallel features make tau = 1 - density small and each logit
    sim / (temp * tau) large, so one bf16 rounding of a weight or one f32
    ulp of a sum moves the next iteration) the plain version's own
    rounding moves it as far, and a right kernel lands where some
    reordered plain version lands. Returns, per result, a dict of (G,) f64
    host tensors ``dev``, ``spread``, ``near``, ``limit``, the bool ``ok``,
    and ``witnesses``, how many were drawn."""
    kw = dict(tau=tau, temp=temp, n_shift=n_shift, matmul_dtype=matmul_dtype)
    want = cosine_shift_batch(prototypes, f[None] * box_mask.float()[..., None], f, **kw)
    wits, spread, near = [], None, [None] * len(results)
    while True:
        new = reordered_witnesses(prototypes, box_mask, f, orders=orders, seed=len(wits),
                                  f64=not wits, **kw)
        wits += new
        dev_w = torch.stack([instance_deviation(w, want) for w in new]).amax(0)
        spread = dev_w if spread is None else torch.maximum(spread, dev_w)
        for r, got in enumerate(results):
            n_r = torch.stack([instance_deviation(got, w) for w in new]).amin(0)
            near[r] = n_r if near[r] is None else torch.minimum(near[r], n_r)
        limit = torch.clamp(2.0 * spread, min=floor)
        dev = [instance_deviation(got, want) for got in results]
        ok = [(d <= limit) | (n <= floor) for d, n in zip(dev, near)]
        if bool(ok[0].all()) or len(wits) - 1 >= max_orders:
            break
    return [dict(dev=d, spread=spread, near=n, limit=limit, ok=o, witnesses=len(wits))
            for d, n, o in zip(dev, near, ok)]


def _smem_bytes(kp: int, bf16: bool, d: int, tb: int, stages: int) -> int:
    """Shared memory of one block of ``csrc/meanshift.cu`` (its ``layout``):
    the TMA rings (bf16), the prototypes' operand copy, the similarities
    (in the update: the W^T tiles, then the partial sums), each feature's
    weight, mask value, norm and prototype, per-prototype arrays,
    barriers, alignment."""
    s = tb * 64
    ring = _WARPGROUPS * stages * 8192 if bf16 else 0
    op = -(-d // 64) * kp * 128 if bf16 else d * kp * 4
    wt = tb * kp * 128 if bf16 else 0
    part = kp * (d + 4) * 4
    one_round = -(-d // 64) <= 2 * _ROUND_BOXES
    x = max(kp * (s + 4) * 4, max(wt, part) if one_round else wt + part)
    small = _up(_up(_up(ring + op, 1024) + x, 16) + 13 * s, 16)
    return (small + (8 + 4 * _ROW_PARTS + _MAX_CLUSTER) * kp * 4
            + _WARPGROUPS * _MAX_STAGES * 8 + 1024)


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


def _plan(g: int, k: int, n: int, d: int, bf16: bool, active,
          smem_bytes=_smem_bytes) -> tuple[int, int, int, int]:
    """(cluster, tiles per block, ring slots, shared memory bytes) of a
    launch: the cluster size whose instances finish in the fewest block
    lifetimes, counted as waves (``active(cluster, smem)`` clusters are
    resident at once) times the 64-feature tiles each block streams; then
    the most ring slots that fit; then the smaller cluster. Clusters of
    16 only where no portable size (at most 8) fits in shared memory."""
    kp = -(-k // 8) * 8
    tiles = -(-n // 64)
    best = None
    for c in _CLUSTERS + (_MAX_CLUSTER,):
        if c == _MAX_CLUSTER and best is not None:
            break
        tb = -(-tiles // c)
        for stages in range(_MAX_STAGES, 0, -1) if bf16 else (1,):
            smem = smem_bytes(kp, bf16, d, tb, stages)
            if smem > _SMEM_LIMIT:
                continue
            fit = active(c, smem)
            if fit > 0:
                key = (-(-g // fit) * tb, -stages, c)
                if best is None or key < best[0]:
                    best = (key, (c, tb, stages, smem))
            break
    if best is None:
        raise ValueError(f"meanshift kernel: N={n}, D={d}, K={k} exceed shared memory")
    return best[1]


def kwide_smem(kernel: str) -> int:
    """Shared memory bytes of ``kwt_sim`` or ``kwt_update``
    (``KWT_SIM_SMEM`` / ``KWT_UPDATE_SMEM``): the ring, barriers, the
    chunk's norms and each warpgroup's rows (sim) or each warpgroup's
    (prototype, weight) pairs of two tiles (update), the 1024-byte
    alignment."""
    kc = KWIDE_CHUNK
    if kernel == "kwt_sim":
        wg, stages = KWIDE_SIM_WARPGROUPS, KWIDE_SIM_STAGES
        return stages * (wg + 1) * _BOX + 2 * stages * 8 + 4 * kc + wg * 64 * 8 + 1024
    wg, stages = KWIDE_UPDATE_WARPGROUPS, KWIDE_UPDATE_STAGES
    return stages * wg * _BOX + 2 * wg * 64 * 8 + 2 * stages * 8 + 1024


def kwide_work_floats(g: int, k: int, n: int, d: int, bf16: bool) -> int:
    """f32 scratch of the second route (``meanshift_kwide_work_floats``),
    each part a multiple of 4 floats: with bf16 operands (D a multiple of
    16) the prototypes' bf16 copy (G K D / 2); then squared norms per 64
    dims, (sum, count) per 64-feature tile, the log-sum-exp per prototype,
    weights and assignments per feature."""
    gk, gn = g * k, g * n
    return ((_up(gk * d // 2, 4) if bf16 else 0) + _up(gk * -(-d // 64), 4)
            + _up(2 * gk * -(-n // 64), 4) + _up(gk, 4) + 2 * _up(gn, 4))


def kwide_plan(g: int, k: int, n: int, d: int, sms: int, per_sm) -> dict:
    """The host's plan of the bf16 second route (``kwt_plan``) on a card of
    ``sms`` SMs whose blocks per SM ``per_sm(kernel, smem)`` gives
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): chunks of 64
    prototypes; kwt_sim's grid (tile groups, chunks, G), each block
    ``tiles_per_block`` 64-feature tiles in rounds of
    ``KWIDE_SIM_WARPGROUPS``, that count the multiple of it whose waves of
    rounds are fewest (the larger on a tie); kwt_update's grid (64-dim
    boxes, chunks, G); shared memory and scratch. ``d``: D as the kernels
    take it (a multiple of 16)."""
    wg = KWIDE_SIM_WARPGROUPS
    chunks, nt, dt = -(-k // KWIDE_CHUNK), -(-n // 64), -(-d // 64)
    sim_smem, upd_smem = kwide_smem("kwt_sim"), kwide_smem("kwt_update")
    sim_per = per_sm("kwt_sim", sim_smem)
    slots, best = sms * sim_per, None
    for tpb in range(wg, nt + wg, wg):
        cost = -(-(g * chunks * -(-nt // tpb)) // slots) * -(-min(tpb, nt) // wg)
        if best is None or cost <= best[0]:
            best = (cost, tpb)
    tpb = best[1]
    return dict(chunks=chunks, tiles=nt, dims=dt, tiles_per_block=tpb,
                sim_blocks=-(-nt // tpb), sim_smem=sim_smem, sim_per_sm=sim_per,
                update_smem=upd_smem, update_per_sm=per_sm("kwt_update", upd_smem), sms=sms,
                work_floats=kwide_work_floats(g, k, n, d, True))


_KWIDE_KEYS = ("chunks", "tiles", "dims", "tiles_per_block", "sim_blocks", "sim_smem",
               "sim_per_sm", "update_smem", "update_per_sm", "sms")


def kernel_kwide_plan(g: int, k: int, n: int, d: int, lib=None) -> dict:
    """The library's own plan (``meanshift_kwide_plan``) in ``kwide_plan``'s
    keys, with its scratch (``meanshift_kwide_work_floats``)."""
    lib = _bind(lib or library("meanshift"))
    out = (ctypes.c_int * len(_KWIDE_KEYS))()
    check(lib.meanshift_kwide_plan(g, k, n, d, out), "meanshift_kwide_plan")
    return dict(zip(_KWIDE_KEYS, out), work_floats=lib.meanshift_kwide_work_floats(g, k, n, d, 1))


_ACTIVE: dict = {}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the signatures of a build of ``csrc/meanshift.cu`` once."""
    if not getattr(lib, "_meanshift_bound", False):
        lib.meanshift_max_clusters.restype = ctypes.c_int
        lib.meanshift_max_clusters.argtypes = [ctypes.c_int] * 3 + [ctypes.c_size_t]
        lib.meanshift_smem_bytes.restype = ctypes.c_size_t
        lib.meanshift_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.meanshift_forward.restype = ctypes.c_int
        lib.meanshift_forward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                                          + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p])
        lib.meanshift_kwide_work_floats.restype = ctypes.c_size_t
        lib.meanshift_kwide_work_floats.argtypes = [ctypes.c_int] * 5
        lib.meanshift_kwide_plan.restype = ctypes.c_int
        lib.meanshift_kwide_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.meanshift_kwide_forward.restype = ctypes.c_int
        lib.meanshift_kwide_forward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                                + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                                   ctypes.c_void_p])
        lib._meanshift_bound = True
    return lib


def launch_plan(g: int, k: int, n: int, d: int, bf16: bool, device, lib=None):
    """The kernel's launch plan on ``device`` (``_plan``, with the shared
    memory the build reports), and ``active(cluster, smem)``: the resident
    cluster counts (``cudaOccupancyMaxActiveClusters``) it was chosen
    from, asked once per (build, device, KP, operands, cluster, smem)."""
    lib = _bind(lib or library("meanshift"))
    kp = -(-k // 8) * 8

    def active(c: int, smem: int) -> int:
        key = (lib._name, device, kp, bf16, c, smem)
        if key not in _ACTIVE:
            with torch.cuda.device(device):
                _ACTIVE[key] = lib.meanshift_max_clusters(kp, int(bf16), c, smem)
        return _ACTIVE[key]

    return _plan(g, k, n, d, bf16, active, lib.meanshift_smem_bytes), active


def route(k: int) -> str:
    """The ``KERNELS`` record of the kernel that runs K prototypes on the
    card: the cluster kernel up to ``CLUSTER_MAX_K``, the second route above."""
    return "meanshift_fixpoint" if k <= CLUSTER_MAX_K else "meanshift_fixpoint_kwide"


def cosine_shift_fixpoint(prototypes, box_mask, f, tau=0.1, temp=0.1, n_shift=10,
                          matmul_dtype=None, lib=None):
    """Mean-shift fixpoint for every instance.

    Args:
        prototypes: (G, K, D) initial prototypes, any K and D.
        box_mask: (G, N) {0, 1} per-instance feature eligibility.
        f: (N, D) unmasked features.
        matmul_dtype: dot operand dtype (None = f32, or torch.bfloat16).
        lib: a build of ``csrc/meanshift.cu`` with ``-D`` overrides
            (``_build.library``); the default build when None.

    Returns:
        prototypes (G, K, D) f32, sim (G, K, N) f32.
    """
    if f.device.type == "cpu":
        feats = f.float()[None] * box_mask.float()[..., None]
        return cosine_shift_batch(prototypes, feats, f, tau, temp, n_shift, matmul_dtype)
    if not (prototypes.is_cuda and box_mask.is_cuda and f.is_cuda):
        raise ValueError("meanshift kernel: all inputs must be CUDA tensors")
    if matmul_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"meanshift kernel: matmul_dtype {matmul_dtype} not supported")
    g, k, d = prototypes.shape
    n = f.shape[0]
    if f.shape != (n, d) or box_mask.shape != (g, n):
        raise ValueError(
            f"meanshift kernel: shapes {tuple(prototypes.shape)}, {tuple(box_mask.shape)}, "
            f"{tuple(f.shape)} not taken (mask (G, N), f (N, D))")
    bf16 = matmul_dtype == torch.bfloat16
    lib = _bind(lib or library("meanshift"))
    prot0 = prototypes.float().contiguous()
    mask = box_mask.float().contiguous()
    f32 = f.float().contiguous()
    nbase = f32.norm(dim=-1).contiguous()
    stream = torch.cuda.current_stream(f.device).cuda_stream
    out_sim = torch.empty((g, k, n), device=f.device, dtype=torch.float32)
    # bf16 dots: D zero-padded to the kernels' multiple of 16 (exact), the
    # features rounded once (read by TMA)
    dk = -(-d // 16) * 16 if bf16 else d
    prot0 = pad_head(prot0, dk)
    fb = pad_head(f.to(torch.bfloat16).contiguous(), dk) if bf16 else None
    out_prot = torch.empty((g, k, dk), device=f.device, dtype=torch.float32)
    if k > CLUSTER_MAX_K:
        work = torch.empty(lib.meanshift_kwide_work_floats(g, k, n, dk, int(bf16)),
                           device=f.device, dtype=torch.float32)
        err = lib.meanshift_kwide_forward(
            prot0.data_ptr(), mask.data_ptr(), None if bf16 else f32.data_ptr(),
            fb.data_ptr() if bf16 else None, nbase.data_ptr(), out_prot.data_ptr(),
            out_sim.data_ptr(), work.data_ptr(), g, k, n, dk, int(n_shift), float(tau),
            float(temp), int(bf16), stream)
        check(err, "meanshift_kwide_forward")
        KERNELS["meanshift_fixpoint_kwide"].launches += 1
    else:
        (cluster, tb, stages, _), _ = launch_plan(g, k, n, dk, bf16, f.device, lib)
        # the dot operands: bf16, or f32 in both layouts
        feats = (None, None, fb) if bf16 else (f32, f32.T.contiguous(), None)
        err = lib.meanshift_forward(
            prot0.data_ptr(), mask.data_ptr(),
            *(None if t is None else t.data_ptr() for t in feats), nbase.data_ptr(),
            out_prot.data_ptr(), out_sim.data_ptr(), g, k, n, dk, int(n_shift), cluster, tb,
            stages, float(tau), float(temp), int(bf16), stream)
        check(err, "meanshift_forward")
        KERNELS["meanshift_fixpoint"].launches += 1
    return (out_prot if dk == d else out_prot[..., :d].contiguous()), out_sim
