"""Transformer building blocks with attention capture.

Port of ``attentionshift_tpu/models/layers.py`` (the slice's blocks):
``Mlp``, ``Attention`` (optionally returning the head-averaged attention
matrix, with the pre-padded token gap masked), the pre-norm ``Block``,
``PatchEmbed`` (space-to-depth + one matmul), ``Conv3x3Matmul``,
``Deconv2x2Matmul``, ``get_2d_sincos_pos_embed`` and
``interpolate_pos_embed``.

Parameters are stored in f32 and cast to the activations' dtype at use,
as flax's ``Dense(dtype=...)`` does, so a bf16 model keeps f32 master
weights and receives f32 gradients.

``Attention(use_kernel=True)`` (the ViT backbone) goes through the
attention ops of ``ops/attention.py`` and so, on the card, through the
hand-written kernels; ``use_kernel=False`` (the decoder heads: 256 wide,
head dim 32, 50 and 196 tokens) takes plain PyTorch ops with autograd,
as the JAX detector leaves those heads off its fused path.

Drop path draws nothing itself: ``Block.forward`` is handed the
per-sample keep masks, so a recompute of the block under activation
checkpointing sees the same masks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention_no_capture, attention_with_capture
from ..ops.image import resize

__all__ = ["Dense", "LayerNorm", "Mlp", "Attention", "Block", "PatchEmbed", "Conv3x3Matmul",
           "Deconv2x2Matmul", "get_2d_sincos_pos_embed", "interpolate_pos_embed"]


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

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, use_kernel: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernel = use_kernel
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, x, capture: bool = False, pad_interval=None):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # (B, H, N, d)
        if not self.use_kernel:
            out, attn = self._plain(q, k, v, capture, pad_interval)
        elif capture:
            out, attn = attention_with_capture(q, k, v, pad_interval)
        else:
            out, attn = attention_no_capture(q, k, v, pad_interval), None
        out = out.transpose(1, 2).reshape(b, n, c).to(x.dtype)
        return self.proj(out), attn

    @staticmethod
    def _plain(q, k, v, capture, pad_interval):
        """PyTorch ops with autograd: logits in the storage dtype (f32 for
        an f32 model), softmax in f32, probabilities rounded to v's dtype."""
        logits = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
        if pad_interval is not None:
            lo, hi = pad_interval
            col = torch.arange(q.shape[2], device=q.device)
            logits = logits + torch.where((col >= lo) & (col < hi), -1e30, 0.0).to(logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1)
        out = torch.matmul(probs.to(v.dtype), v)
        return out, (probs.mean(dim=1).detach() if capture else None)


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0, use_kernel: bool = True):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, use_kernel)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, capture: bool = False, pad_interval=None, drop_masks=None):
        """``drop_masks``: None (deterministic), or the two per-sample keep
        masks (B,) of the attention and the MLP branch."""
        y, attn = self.attn(self.norm1(x), capture, pad_interval)
        x = x + self._drop_path(y, None if drop_masks is None else drop_masks[0])
        z = self.mlp(self.norm2(x))
        return x + self._drop_path(z, None if drop_masks is None else drop_masks[1]), attn

    def _drop_path(self, x, mask):
        if mask is None or self.drop_path == 0.0:
            return x
        keep = 1.0 - self.drop_path
        return x / keep * mask.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


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


class Conv3x3Matmul(nn.Module):
    """3x3 SAME conv as 9 shifted matmuls accumulated in f32, channel-last,
    with the flax conv's (3, 3, Cin, Cout) kernel layout."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        b, h, w, _ = x.shape
        k = self.weight.to(x.dtype)
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        acc = None
        for dy in range(3):
            for dx in range(3):
                t = torch.matmul(xp[:, dy:dy + h, dx:dx + w], k[dy, dx]).float()
                acc = t if acc is None else acc + t
        return (acc + self.bias.float()).to(x.dtype)


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


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """Fixed 2-D sin-cos positional embedding (MAE convention)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape(2, 1, grid_size, grid_size)

    def emb_1d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    pos = np.concatenate([emb_1d(embed_dim // 2, grid[0]), emb_1d(embed_dim // 2, grid[1])],
                         axis=1).astype(np.float32)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim), np.float32), pos], axis=0)
    return pos


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
