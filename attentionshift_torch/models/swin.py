"""Swin Transformer backbone (shifted-window attention) with the attnshift hook.

Port of ``attentionshift_tpu/models/swin.py``: patch embed (a stride-p
conv), four stages of shifted-window blocks with a relative position bias
and patch merging between them, each stage's LayerNorm-ed output in the
feature pyramid. With ``attnshift=True`` the stride-32 map also runs
``global_blocks`` full-attention blocks with ``point_tokens`` learnable
tokens appended, and the output follows the ViT engine's contract:
``attns`` (a zero cls row and column prepended), ``last_feat`` (a zero
cls token prepended), ``point_tokens``, ``outputs_class`` and
``outputs_coord``. Layout is channel-last, as in the JAX package.

The windowed products are small (49 tokens at window 7) and stay
``torch.matmul``, as the JAX package leaves them to plain einsums: logits
in f32 from the storage-dtype operands, the shift mask of -100 across
region boundaries, probabilities rounded to v's dtype for PV. The global
blocks are the port's ``layers.Block`` (LayerNorm eps 1e-6; the Swin
layers' own norms take 1e-5) with ``use_kernel=True``, so on the card
their attention runs the hand-written kernels at Swin's head shape:
``max(num_heads[-1], 1)`` heads of ``8 * embed_dim / num_heads[-1]``
(24 heads of 32 for embed 96). Every global block captures, as in JAX.

A block's window is ``min(window_size, h, w)`` of the map it meets, and
its relative-position table is sized by that window: ``img_size`` (h, w)
says which maps the model is built for, so a stage whose map is smaller
than the window gets the smaller table, as the JAX module's parameters
do when initialised at that size. Without ``img_size`` every table has
the full window. Built on ``device`` (``cuda`` unless asked otherwise)
with parameters in f32; ``dtype`` is the compute dtype (bf16 on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .layers import Block, Dense, LayerNorm, Mlp
from .vit import MlpHead

__all__ = ["SwinTransformer", "SwinBlock", "WindowAttention", "PatchMerging", "window_partition",
           "window_reverse"]


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]  # (N, N)


def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask (-100 across region boundaries)."""
    img_mask = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wss] = cnt
            cnt += 1
    mw = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _shift_mask_on(h: int, w: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    """``_shift_mask`` as a tensor on ``device``, made and copied once per
    (map, window, shift, device): a constant, as in the JAX package."""
    return torch.from_numpy(_shift_mask(h, w, ws, shift)).to(device)


class PatchConv(nn.Conv2d):
    """Stride-p patchifier as ``nn.Conv2d`` on a channel-last image,
    computing in the input's dtype."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int):
        super().__init__(in_channels, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     self.stride)
        return y.permute(0, 2, 3, 1)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with the relative-position
    bias table ((2 ws - 1)^2, H) and an optional (nW, N, N) additive mask."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_relative_position_index(window_size)).reshape(-1),
                             persistent=False)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x, mask=None, capture: bool = False):
        """x: (B_, N, C) windows; mask: (nW, N, N) or None. Returns the
        projected output and, with ``capture``, the head mean (B_, N, N)."""
        b_, n, c = x.shape
        h = self.num_heads
        hd = c // h
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, h).permute(2, 0, 1)  # (H, N, N)
        qkv = self.qkv(x).reshape(b_, n, 3, h, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B_, H, N, d)
        logits = torch.matmul((q * hd**-0.5).float(), k.float().transpose(-1, -2))
        logits = logits + bias[None].float()
        if mask is not None:
            nw = mask.shape[0]
            logits = logits.reshape(b_ // nw, nw, h, n, n) + mask[None, :, None]
            logits = logits.reshape(b_, h, n, n)
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs.to(v.dtype).float(), v.float())
        out = self.proj(out.transpose(1, 2).reshape(b_, n, c).to(x.dtype))
        return out, (probs.mean(dim=1).detach() if capture else None)


class SwinBlock(nn.Module):
    """Pre-norm shifted-window block on a (B, H, W, C) map (H and W
    divisible by the block's window, which is the configured window
    clamped to the map the block is built for)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, capture: bool = False):
        b, h, w, c = x.shape
        # the window clamped to the map; no shift when one window covers it
        ws = min(self.window_size, h, w)
        if ws != self.window_size:
            raise ValueError(f"SwinBlock: a {h}x{w} map takes window {ws}, but this block's "
                             f"position table is for window {self.window_size}: build the "
                             f"model with the img_size it runs at")
        shift = self.shift if ws < min(h, w) else 0
        y = self.norm1(x)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _shift_mask_on(h, w, ws, shift, y.device)
        wins, attn = self.attn(window_partition(y, ws), mask, capture)
        y = window_reverse(wins, ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x)), attn


class PatchMerging(nn.Module):
    """2x2 neighbourhood gather (4C), LayerNorm, Dense to 2C without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class SwinTransformer(nn.Module):
    """Four-stage Swin; returns ``feature``, the pyramid of per-stage
    LayerNorm-ed maps, and with ``attnshift`` the ViT engine's contract."""

    def __init__(self, embed_dim: int = 96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 4, mlp_ratio: float = 4.0,
                 out_indices=(0, 1, 2, 3), attnshift: bool = False, point_tokens: int = 100,
                 num_classes: int = 20, global_blocks: int = 4, img_size=None,
                 use_kernel: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        self.attnshift = attnshift
        self.point_tokens = point_tokens
        self.global_blocks = global_blocks
        self.dtype = dtype
        self.patch_embed = PatchConv(3, embed_dim, patch_size)
        self.patch_norm = LayerNorm(embed_dim, eps=1e-5)
        dim = embed_dim
        hw = None if img_size is None else (img_size[0] // patch_size, img_size[1] // patch_size)
        for st, (depth, heads) in enumerate(zip(self.depths, num_heads)):
            ws = window_size if hw is None else min(window_size, *hw)
            for i in range(depth):
                shift = 0 if i % 2 == 0 else window_size // 2
                setattr(self, f"stage{st}_block{i}", SwinBlock(dim, heads, ws, shift, mlp_ratio))
            if st in self.out_indices:
                setattr(self, f"out_norm{st}", LayerNorm(dim, eps=1e-5))
            if st < len(self.depths) - 1:
                setattr(self, f"merge{st}", PatchMerging(dim))
                dim *= 2
                hw = None if hw is None else (hw[0] // 2, hw[1] // 2)
        if attnshift:
            self.point_token = nn.Parameter(torch.zeros(1, point_tokens, dim))
            self.point_pos_embed = nn.Parameter(torch.zeros(1, point_tokens, dim))
            for i in range(global_blocks):
                setattr(self, f"global_block{i}",
                        Block(dim, max(num_heads[-1], 1), mlp_ratio, use_kernel=use_kernel))
            self.class_embed = MlpHead(dim, dim, num_classes)
            self.bbox_embed = MlpHead(dim, dim, 2)
        self.to(dev)

    def init_weights(self, seed: int = 0) -> "SwinTransformer":
        """Seeded random init: N(0, 0.02) matrices, conv kernel, position
        tables and tokens, zero biases, unit norm scales."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        with torch.no_grad():
            for name, t in self.named_parameters():
                if name.endswith("bias"):
                    val = torch.zeros(t.shape)
                elif t.dim() == 1:
                    val = torch.ones(t.shape)
                else:
                    val = torch.randn(t.shape, generator=gen) * 0.02
                t.copy_(val)
        return self

    def forward(self, img: torch.Tensor) -> dict:
        """img: (B, H, W, 3) with every stage's map divisible by its window
        (896x1344 at patch 4 and window 7; 800x1344 is not)."""
        x = self.patch_norm(self.patch_embed(img.to(self.dtype)))
        feats = []
        for st, depth in enumerate(self.depths):
            for i in range(depth):
                x, _ = getattr(self, f"stage{st}_block{i}")(x)
            if st in self.out_indices:
                feats.append(getattr(self, f"out_norm{st}")(x))
            if st < len(self.depths) - 1:
                x = getattr(self, f"merge{st}")(x)
        ret = dict(feature=tuple(feats))
        if not self.attnshift:
            return ret

        b, hh, ww, c = feats[-1].shape
        p = self.point_tokens
        tokens = torch.cat([feats[-1].reshape(b, hh * ww, c),
                            (self.point_token + self.point_pos_embed).to(x.dtype).expand(b, p, c)],
                           dim=1)
        attns = []
        for i in range(self.global_blocks):
            tokens, attn = getattr(self, f"global_block{i}")(tokens, capture=True)
            attns.append(attn)
        last, pts = tokens[:, :hh * ww], tokens[:, hh * ww:]
        ret.update(
            # a zero "cls" row and column, so that the (cls | patches |
            # points) layout matches the ViT engine's contract
            attns=F.pad(torch.stack(attns, dim=0), (1, 0, 1, 0)),
            last_feat=torch.cat([last.new_zeros(b, 1, c), last], dim=1),
            point_tokens=pts,
            outputs_class=self.class_embed(pts),
            outputs_coord=torch.sigmoid(self.bbox_embed(pts)),
        )
        return ret
