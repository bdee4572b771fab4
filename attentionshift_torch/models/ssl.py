"""Self-supervised projection heads and the masked-image-modeling ViT.

Port of ``attentionshift_tpu/models/ssl.py``:

- ``DINOHead``: an MLP trunk (hidden -> bottleneck, exact GELU), L2
  normalisation, then a weight-normed prototype layer without bias whose
  rows are unit-normalised at use (``weight_v``), times a learnable gain
  ``weight_g`` unless ``norm_last_layer`` freezes it at 1.
- ``IBOTHead``: the same trunk; token 0 goes through the cls prototype
  layer and the patch tokens through a second (or, with
  ``shared_head``, the same) patch prototype layer.
- ``MIMViT``: a plain ViT forward in which a boolean patch mask swaps the
  masked patch embeddings for a learned mask token before the blocks.
  Its blocks are ``layers.Block``, so on the card their attention runs
  the flash kernel forward and the backward pair, at (B, heads, 1 + N,
  d).

The heads compute in f32 whatever their input's dtype, as the JAX heads
(f32 parameters, no dtype of their own) promote it. Each module is built
on ``device`` (``cuda`` unless asked otherwise).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .layers import Block, Dense, LayerNorm, PatchEmbed, interpolate_pos_embed

__all__ = ["DINOHead", "IBOTHead", "MIMViT"]


def _init(module: nn.Module, seed: int) -> None:
    """Seeded random init: N(0, 0.02) matrices and tokens, zero biases,
    unit norm scales and gains."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, t in module.named_parameters():
            if name.endswith("bias"):
                t.zero_()
            elif t.dim() == 1:
                t.fill_(1.0)
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.02)


class _Prototypes(nn.Module):
    """Weight-normed linear without bias: x @ normalize(V)^T (* g)."""

    def __init__(self, in_dim: int, out_dim: int, learnable_gain: bool = False):
        super().__init__()
        self.weight_v = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.weight_g = nn.Parameter(torch.ones(out_dim)) if learnable_gain else None

    def forward(self, x):
        vn = self.weight_v / self.weight_v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        if self.weight_g is not None:
            vn = vn * self.weight_g[:, None]
        return x @ vn.T


class _Trunk(nn.Module):
    """``nlayers`` Dense layers: in -> hidden ... -> bottleneck, exact GELU
    between them; the output L2-normalised."""

    def __init__(self, in_dim: int, nlayers: int, hidden_dim: int, bottleneck_dim: int):
        super().__init__()
        n = max(nlayers, 1)
        dims = [in_dim] + [hidden_dim] * (n - 1) + [bottleneck_dim]
        self.mlp = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        x = x.float()
        for layer in self.mlp[:-1]:
            x = F.gelu(layer(x))
        x = self.mlp[-1](x)
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, nlayers: int = 3, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, norm_last_layer: bool = True, device=None):
        super().__init__()
        self.trunk = _Trunk(in_dim, nlayers, hidden_dim, bottleneck_dim)
        self.last_layer = _Prototypes(bottleneck_dim, out_dim, not norm_last_layer)
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "DINOHead":
        _init(self, seed)
        return self

    def forward(self, x):
        """(..., in_dim) -> (..., out_dim) f32 logits."""
        return self.last_layer(self.trunk(x))


class IBOTHead(nn.Module):
    """DINO trunk plus a separate or shared patch prototype layer. A
    (B, 1 + N, D) input gives (cls logits (B, out_dim), patch logits
    (B, N, patch_out_dim)); a (B, D) input the cls logits only."""

    def __init__(self, in_dim: int, out_dim: int, patch_out_dim: int = 8192, nlayers: int = 3,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256, norm_last_layer: bool = True,
                 shared_head: bool = False, device=None):
        super().__init__()
        self.trunk = _Trunk(in_dim, nlayers, hidden_dim, bottleneck_dim)
        self.last_layer = _Prototypes(bottleneck_dim, out_dim, not norm_last_layer)
        self.last_layer2 = None if shared_head else _Prototypes(bottleneck_dim, patch_out_dim,
                                                                not norm_last_layer)
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "IBOTHead":
        _init(self, seed)
        return self

    def forward(self, x):
        z = self.trunk(x)
        if x.dim() == 2:
            return self.last_layer(z)
        patch_layer = self.last_layer if self.last_layer2 is None else self.last_layer2
        return self.last_layer(z[:, 0]), patch_layer(z[:, 1:])


class MIMViT(nn.Module):
    """ViT forward with masked-patch substitution (iBOT/MAE-style MIM).

    ``forward(img, mask=None)``: img (B, H, W, 3); mask (B, Hp*Wp) bool,
    True = the patch embedding replaced by the mask token. Returns the
    (B, 1 + N, D) final tokens (cls + patches), LayerNorm-ed.
    """

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, patch_size: int = 16,
                 img_size: int = 224, use_kernel: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        d = embed_dim
        grid = img_size // patch_size
        self.patch_size, self.embed_dim, self.dtype = patch_size, d, dtype
        self.patch_embed = PatchEmbed(d, patch_size)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, d))
        self.blocks = nn.ModuleList(Block(d, num_heads, mlp_ratio, qkv_bias, use_kernel=use_kernel)
                                    for _ in range(depth))
        self.norm = LayerNorm(d)
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "MIMViT":
        _init(self, seed)
        return self

    def forward(self, img: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, h, w, _ = img.shape
        hp, wp = h // self.patch_size, w // self.patch_size
        d = self.embed_dim
        x = self.patch_embed(img.to(self.dtype)).reshape(b, hp * wp, d)
        if mask is not None:
            x = torch.where(mask[..., None], self.mask_token.to(x.dtype), x)
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, hp, wp).to(x.dtype)
        for blk in self.blocks:
            x, _ = blk(x)
        return self.norm(x)
