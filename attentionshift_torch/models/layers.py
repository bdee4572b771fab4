"""Transformer building blocks with attention capture.

Port of ``attentionshift_tpu/models/layers.py`` (the slice's blocks):
``Mlp``, ``Attention`` (optionally returning the head-averaged attention
matrix, with the pre-padded token gap masked), the pre-norm ``Block``,
``PatchEmbed`` (space-to-depth + one matmul), ``Deconv2x2Matmul`` and
``interpolate_pos_embed``.

Parameters are stored in f32 and cast to the activations' dtype at use,
as flax's ``Dense(dtype=...)`` does, so a bf16 model keeps f32 master
weights. Drop path is inert on this deterministic path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention_no_capture, attention_with_capture
from ..ops.image import resize

__all__ = ["Dense", "LayerNorm", "Mlp", "Attention", "Block", "PatchEmbed", "Deconv2x2Matmul",
           "interpolate_pos_embed"]


class Dense(nn.Linear):
    """``nn.Linear`` computing in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-6) whose output keeps the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """Multi-head self-attention (fused qkv, scale head_dim**-0.5); with
    ``capture`` it also returns the head-averaged probabilities (B, T, T)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, x, capture: bool = False, pad_interval=None):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # (B, H, N, d)
        if capture:
            out, attn = attention_with_capture(q, k, v, pad_interval)
        else:
            out, attn = attention_no_capture(q, k, v, pad_interval), None
        out = out.transpose(1, 2).reshape(b, n, c).to(x.dtype)
        return self.proj(out), attn


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, capture: bool = False, pad_interval=None):
        y, attn = self.attn(self.norm1(x), capture, pad_interval)
        x = x + y
        return x + self.mlp(self.norm2(x)), attn


class PatchEmbed(nn.Module):
    """Stride-p patchifier as space-to-depth + one matmul; the weight's
    input axis is ordered (p, p, C) like the flax conv kernel's reshape."""

    def __init__(self, embed_dim: int, patch_size: int = 16, in_channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Dense(patch_size * patch_size * in_channels, embed_dim)

    def forward(self, x):
        b, h, w, c = x.shape  # channel-last
        p = self.patch_size
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return self.proj(x.reshape(b, h // p, w // p, p * p * c))


class Deconv2x2Matmul(nn.Module):
    """2x2 stride-2 transposed conv as one matmul + pixel shuffle, with
    ``nn.ConvTranspose2d``'s (Cin, Cout, 2, 2) weight layout; channel-last."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        b, h, w, _ = x.shape
        y = torch.einsum("bhwc,cdij->bhiwjd", x.float(), self.weight.to(x.dtype).float())
        y = y + self.bias.float()
        return y.reshape(b, 2 * h, 2 * w, -1).to(x.dtype)


class BatchNorm(nn.Module):
    """Inference batch norm over the last (channel) axis, eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * mul + self.bias).to(x.dtype)


def interpolate_pos_embed(pos_embed: torch.Tensor, hp: int, wp: int, num_prefix: int = 1):
    """Bicubic-resize (A=-0.75, half-pixel) the square patch grid of a
    (1, prefix + s*s, D) position embedding to (hp, wp)."""
    prefix, patch = pos_embed[:, :num_prefix], pos_embed[:, num_prefix:]
    n = patch.shape[1]
    side = int(round(float(np.sqrt(n))))
    if side * side != n:
        raise ValueError(f"pos embed grid is not square: {n}")
    if (side, side) == (hp, wp):
        return pos_embed
    d = patch.shape[-1]
    grid = patch.reshape(1, side, side, d).permute(0, 3, 1, 2)
    grid = resize(grid, (hp, wp), method="bicubic")
    return torch.cat([prefix, grid.permute(0, 2, 3, 1).reshape(1, hp * wp, d)], dim=1)
