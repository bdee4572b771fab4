"""Cosine mean-shift fixpoint (Stage C).

Port of ``attentionshift_tpu/ops/meanshift_kernel.py`` and of the plain
``cosine_shift_batch`` it replaces (``pseudo/meanshift.py:49-123``).
``cosine_shift_fixpoint`` is the wrapper: a CPU tensor takes the plain
version ``cosine_shift_batch``, a CUDA tensor launches
``csrc/meanshift.cu`` or raises.

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

__all__ = ["cosine_shift_batch", "cosine_shift_fixpoint"]

_SMEM_LIMIT = 227 * 1024
_CLUSTER = 8  # blocks per instance, as in csrc/meanshift.cu


def _mm(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round a dot operand to ``dtype`` and back to f32 (exact products)."""
    x = x.float()
    return x if dtype in (None, torch.float32) else x.to(dtype).float()


def cosine_shift_batch(prototypes, feats, feats_org, tau=0.1, temp=0.1, n_shift=10,
                       matmul_dtype=None):
    """Plain version. prototypes (G, K, D), feats (G, N, D) box-masked,
    feats_org (N, D) -> prototypes (G, K, D) f32, sim (G, K, N) f32."""
    g, k, d = prototypes.shape
    nb = feats.float().norm(dim=-1).clamp_min(1e-8)  # (G, N)
    fm = _mm(feats, matmul_dtype)

    def cos_feats(prot):
        num = torch.matmul(_mm(prot, matmul_dtype), fm.transpose(1, 2))
        na = prot.norm(dim=-1).clamp_min(1e-8)
        return num / (na[..., None] * nb[:, None, :])

    prot = prototypes.float()
    tau_arr = torch.full((g, k, 1), float(tau), device=prot.device)
    kk = torch.arange(k, device=prot.device)[None, :, None]
    for _ in range(n_shift):
        sim = cos_feats(prot)
        scaled = sim / (temp * tau_arr)
        logw = scaled - torch.logsumexp(scaled, dim=-1, keepdim=True)
        weight = torch.exp(logw)
        mask_w = (kk == torch.argmax(logw, dim=1, keepdim=True)).float()
        prot = torch.matmul(_mm(weight * mask_w, matmul_dtype), fm)
        sim2 = cos_feats(prot)
        cnt = mask_w.sum(-1)
        dens = (sim2 * mask_w).sum(-1)
        dens = 1.0 - torch.where(cnt >= 1, dens / cnt.clamp_min(1.0), torch.zeros_like(dens))
        tau_arr = dens.clamp_min(1e-10)[..., None]
    num = torch.matmul(_mm(prot, matmul_dtype), _mm(feats_org, matmul_dtype).T)
    na = prot.norm(dim=-1).clamp_min(1e-8)
    nbo = feats_org.float().norm(dim=-1).clamp_min(1e-8)
    return prot, num / (na[..., None] * nbo)


def cosine_shift_fixpoint(prototypes, box_mask, f, tau=0.1, temp=0.1, n_shift=10,
                          matmul_dtype=None):
    """Mean-shift fixpoint for every instance.

    Args:
        prototypes: (G, K, D) initial prototypes.
        box_mask: (G, N) {0, 1} per-instance feature eligibility.
        f: (N, D) unmasked features.
        matmul_dtype: dot operand dtype (None = f32, or torch.bfloat16).

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
    if k > 32 or f.shape != (n, d) or box_mask.shape != (g, n):
        raise ValueError(
            f"meanshift kernel: shapes {tuple(prototypes.shape)}, {tuple(box_mask.shape)}, "
            f"{tuple(f.shape)} not taken (K <= 32, mask (G, N), f (N, D))")
    bf16 = matmul_dtype == torch.bfloat16
    if bf16 and d % 16:
        raise ValueError(f"meanshift kernel: bf16 dots need D % 16 == 0, got D={d}")
    kp = -(-k // 8) * 8
    np_ = -(-n // (16 * _CLUSTER)) * 16 * _CLUSTER  # 8 blocks x a multiple of 16 features
    s = np_ // _CLUSTER
    if 4 * (2 * kp * d + kp * s + 2 * s + 5 * kp) > _SMEM_LIMIT:
        raise ValueError(f"meanshift kernel: N={n}, D={d}, K={k} exceed shared memory")
    prot0 = prototypes.float().contiguous()
    mask = box_mask.float().contiguous()
    f32 = f.float().contiguous()
    nbase = f32.norm(dim=-1).contiguous()
    if bf16:
        # the dot operands rounded once, in both layouts, zero rows to NP
        fb = torch.zeros((np_, d), device=f.device, dtype=torch.bfloat16)
        fb[:n] = f32
        feats = (None, None, fb, fb.T.contiguous())
    else:
        feats = (f32, f32.T.contiguous(), None, None)
    out_prot = torch.empty((g, k, d), device=f.device, dtype=torch.float32)
    out_sim = torch.empty((g, k, n), device=f.device, dtype=torch.float32)
    fn = library("meanshift").meanshift_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(prot0.data_ptr(), mask.data_ptr(),
             *(None if t is None else t.data_ptr() for t in feats),
             nbase.data_ptr(), out_prot.data_ptr(), out_sim.data_ptr(), g, k, n, np_, d,
             int(n_shift), float(tau), float(temp), int(bf16),
             torch.cuda.current_stream(f.device).cuda_stream)
    check(err, "meanshift_forward")
    KERNELS["meanshift_fixpoint"].launches += 1
    return out_prot, out_sim
