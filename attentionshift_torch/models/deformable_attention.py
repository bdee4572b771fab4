"""Deformable conv-attention (support module of the part-refinement head).

Port of ``attentionshift_tpu/models/deformable_attention.py``: per query
location a depthwise conv tower predicts ``k*k`` sampling offsets; keys
and values are sampled bilinearly (``align_corners=True``) at the
offset taps of the k x k grid around the location, and each head
attends over its k*k samples with a scaled dot product.

Layout as in JAX: channel-last (B, H, W, C) in and out; the depthwise
convs are ``groups=C`` convolutions (the flax (3, 3, 1, C) kernels as
(C, 1, 3, 3)); the 1x1 convs are ``Dense`` layers. The tap grid is
ordered row-major over (dy, dx) and read as xy, and the sampled K and V
split into heads channel-major, (B, heads, head_dim, H, W, k*k). Plain
tensor code with autograd: no kernel. Built on ``device`` (``cuda``
unless asked otherwise).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.sampling import grid_sample_bilinear
from .layers import Dense, LayerNorm

__all__ = ["DeformableConvAttention"]


class DepthwiseConv(nn.Conv2d):
    """k x k SAME depthwise conv on channel-last input, computing in the
    input's dtype."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__(channels, channels, kernel_size, padding=kernel_size // 2,
                         groups=channels)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class DeformableConvAttention(nn.Module):
    def __init__(self, channels: int, n_heads: int = 4, kernel_size: int = 3,
                 offset_range_factor: float = 2.0, tau: float = 1.0, device=None):
        super().__init__()
        self.n_heads, self.kernel_size = n_heads, kernel_size
        self.offset_range_factor, self.tau = offset_range_factor, tau
        k2 = kernel_size ** 2
        for i in range(2):
            setattr(self, f"off_conv{i}", DepthwiseConv(channels, kernel_size))
            setattr(self, f"off_ln{i}", LayerNorm(channels))
        self.off_out = Dense(channels, 2 * k2, bias=False)
        self.proj_q = Dense(channels, channels)
        self.proj_k = Dense(channels, channels)
        self.proj_v = Dense(channels, channels)
        self.proj_out = Dense(channels, channels)
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "DeformableConvAttention":
        """Seeded random init: N(0, 0.02) kernels, zero biases, unit norm
        scales."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            for name, t in self.named_parameters():
                if name.endswith("bias"):
                    t.zero_()
                elif t.dim() == 1:
                    t.fill_(1.0)
                else:
                    t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) -> (B, H, W, C)."""
        b, h, w, c = x.shape
        ks = self.kernel_size
        k2 = ks * ks
        head_dim = c // self.n_heads
        o = x
        for i in range(2):
            o = F.gelu(getattr(self, f"off_ln{i}")(getattr(self, f"off_conv{i}")(o)))
        offsets = torch.tanh(self.off_out(o)) * self.offset_range_factor
        offsets = offsets.reshape(b, h, w, k2, 2).float()
        q, kf, vf = self.proj_q(x), self.proj_k(x), self.proj_v(x)

        # the k x k tap grid around each query location, as xy
        r = torch.arange(ks, dtype=torch.float32, device=x.device) - ks // 2
        base = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1).reshape(k2, 2).flip(-1)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                                torch.arange(w, dtype=torch.float32, device=x.device),
                                indexing="ij")
        centers = torch.stack([xs, ys], dim=-1)  # (H, W, 2) xy
        pos = centers[None, :, :, None, :] + base + offsets  # (B, H, W, k2, 2)
        grid = torch.stack([pos[..., 0] / max(w - 1, 1) * 2 - 1,
                            pos[..., 1] / max(h - 1, 1) * 2 - 1], dim=-1)

        def sample(feat):  # (B, H, W, C) -> (B, C, H, W, k2)
            return torch.stack([grid_sample_bilinear(feat[i].permute(2, 0, 1), grid[i],
                                                     align_corners=True) for i in range(b)])

        kh = sample(kf).reshape(b, self.n_heads, head_dim, h, w, k2)
        vh = sample(vf).reshape(b, self.n_heads, head_dim, h, w, k2)
        qh = q.reshape(b, h, w, self.n_heads, head_dim)
        logits = torch.einsum("bhwnd,bndhwk->bhwnk", qh.float(), kh.float())
        attn = torch.softmax(logits * head_dim ** -0.5 / self.tau, dim=-1)
        out = torch.einsum("bhwnk,bndhwk->bhwnd", attn.to(vh.dtype).float(), vh.float())
        return self.proj_out(out.reshape(b, h, w, c).to(x.dtype))
