"""MAE-pretrain-style plain-ViT detection backbone.

Port of ``attentionshift_tpu/models/mae_encoder.py``: a ViT without a
cls token over stride-16 patches, with the 1-D sinusoid position table,
optional LayerScale (``init_values``), optional window/global split
attention (each block attends inside ``window x window`` tiles except
every ``split_attn_freq``-th, and only while the grid is larger than the
window), LayerNorm-ed taps at ``out_indices`` and the 4-level
deconv/identity/maxpool pyramid.

Layout is channel-last, as in JAX. A windowed block reshapes its
(B, Hp*Wp, C) tokens to (B * nh * nw, window^2, C) in JAX's transpose
order; with split attention the grid must divide by the window (JAX
asserts it, the port raises). The attention is ``layers.Attention``:
with ``use_kernel`` (the default) it runs the attention ops of
``ops/attention.py``, so on the card the flash kernel forward and the
backward pair, at (B * nh * nw, heads, window^2, d) in windowed blocks
and (B, heads, Hp*Wp, d) in global ones. The pyramid's 2x2 transposed
convs are ``layers.Deconv2x2Matmul`` and ``fpn1_bn`` a BatchNorm with
running statistics, as in the ViT detector. Parameters are f32;
``dtype`` is the compute dtype (bf16 on the card). Built on ``device``
(``cuda`` unless asked otherwise).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .initializers import flax_init
from .layers import Attention, BatchNorm, Deconv2x2Matmul, LayerNorm, Mlp, PatchEmbed

__all__ = ["MAEVisionTransformer", "get_sinusoid_encoding_table"]


def get_sinusoid_encoding_table(n_position: int, d_hid: int) -> np.ndarray:
    """The classic transformer sinusoid table, (n_position, d_hid) f32."""
    pos = np.arange(n_position)[:, None]
    i = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


@functools.lru_cache(maxsize=16)
def _pos_table(n_position: int, d_hid: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """The sinusoid table on ``device``, made once per shape (at a 56 x 84
    grid of 768 the numpy table takes tens of ms on the host)."""
    table = torch.from_numpy(get_sinusoid_encoding_table(n_position, d_hid))
    return table.to(device=device, dtype=dtype)


class _MAEBlock(nn.Module):
    """Pre-norm block with optional LayerScale and windowed attention."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 init_values: float = 0.0, use_kernel: bool = True):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, use_kernel)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if init_values > 0.0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    @staticmethod
    def _scale(gamma, y):
        return y if gamma is None else y * gamma.to(y.dtype)

    def forward(self, x, grid_hw, window: int = 0):
        h = self.norm1(x)
        if window > 0:
            hp, wp = grid_hw
            b, n, d = h.shape
            nh, nw = hp // window, wp // window
            hw = h.reshape(b, nh, window, nw, window, d).permute(0, 1, 3, 2, 4, 5)
            yw, _ = self.attn(hw.reshape(b * nh * nw, window * window, d))
            yw = yw.reshape(b, nh, nw, window, window, d).permute(0, 1, 3, 2, 4, 5)
            y = yw.reshape(b, n, d)
        else:
            y, _ = self.attn(h)
        x = x + self._scale(self.gamma_1, y)
        return x + self._scale(self.gamma_2, self.mlp(self.norm2(x)))


class MAEVisionTransformer(nn.Module):
    """Sinusoid-position ViT backbone. ``forward`` returns a tuple of 4
    channel-last maps at strides (4, 8, 16, 32) with ``with_fpn``, else the
    raw stride-16 taps."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 init_values: float = 0.0, out_indices=(3, 5, 7, 11), with_fpn: bool = True,
                 split_attn_freq: int = 0, window: int = 14, use_kernel: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        d = embed_dim
        self.patch_size, self.embed_dim = patch_size, d
        self.out_indices, self.with_fpn = tuple(out_indices), with_fpn
        self.split_attn_freq, self.window = split_attn_freq, window
        self.dtype = dtype
        self.patch_embed = PatchEmbed(d, patch_size)
        self.blocks = nn.ModuleList(_MAEBlock(d, num_heads, mlp_ratio, qkv_bias, init_values,
                                              use_kernel) for _ in range(depth))
        self.tapnorm = nn.ModuleList(LayerNorm(d) for _ in self.out_indices)
        if with_fpn:
            self.fpn1_deconv1 = Deconv2x2Matmul(d, d)
            self.fpn1_bn = BatchNorm(d)
            self.fpn1_deconv2 = Deconv2x2Matmul(d, d)
            self.fpn2_deconv = Deconv2x2Matmul(d, d)
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "MAEVisionTransformer":
        """Seeded random init by the JAX module's rules
        (``models/initializers.py``): ``lecun_normal`` matrices, patch
        embedding and pyramid deconvs, zero biases and running means, unit
        norm scales and running variances; the LayerScale vectors keep
        ``init_values``."""
        return flax_init(self, seed, {}, keep=("gamma_1", "gamma_2"))

    def block_windows(self, hp: int, wp: int) -> list[int]:
        """Each block's attention window at an (hp, wp) grid: 0 = global."""
        if self.split_attn_freq <= 0:
            return [0] * len(self.blocks)
        if hp % self.window or wp % self.window:
            raise ValueError(f"split attention needs a grid divisible by the window "
                             f"{self.window}, got {(hp, wp)}")
        big = hp > self.window and wp > self.window
        return [self.window if big and (i + 1) % self.split_attn_freq != 0 else 0
                for i in range(len(self.blocks))]

    def forward(self, img: torch.Tensor):
        """img: (B, H, W, 3), H and W divisible by the patch size."""
        b, h, w, _ = img.shape
        hp, wp = h // self.patch_size, w // self.patch_size
        d = self.embed_dim
        x = self.patch_embed(img.to(self.dtype)).reshape(b, hp * wp, d)
        x = x + _pos_table(hp * wp, d, x.device, x.dtype)[None]
        taps = []
        for i, (blk, window) in enumerate(zip(self.blocks, self.block_windows(hp, wp))):
            x = blk(x, (hp, wp), window)
            if i in self.out_indices:
                taps.append(self.tapnorm[len(taps)](x).reshape(b, hp, wp, d))
        if not self.with_fpn:
            return tuple(taps)
        f1 = self.fpn1_deconv2(F.gelu(self.fpn1_bn(self.fpn1_deconv1(taps[0]))))
        f4 = F.max_pool2d(taps[3].permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return (f1, self.fpn2_deconv(taps[1]), taps[2], f4)
