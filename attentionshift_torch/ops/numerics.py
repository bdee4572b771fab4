"""Floating-point spacing shared by the kernels' limits."""

from __future__ import annotations

import torch

__all__ = ["F32_MIN_NORMAL", "bf16_steps"]

F32_MIN_NORMAL = 2.0 ** -126


def bf16_steps(x):
    """The spacing of bf16 numbers at each |x| (f32): 2^(k - 7) for |x| in
    [2^k, 2^(k+1)), and 2^-133, the subnormal spacing, below 2^-126."""
    _, exp = torch.frexp(x.float().abs().clamp_min(F32_MIN_NORMAL))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)
