"""MAE masked-reconstruction auxiliary head.

Port of ``attentionshift_tpu/models/mae_head.py``: the encoder's tokens
are masked again (ratio 0.75) by a random shuffle, the kept ones and a
learned mask token are decoded in the original order by a 4-block ViT
decoder with the fixed sin-cos position embedding, and each patch's
pixels are regressed with MAE's normalised-pixel MSE over the masked
patches only. The masking noise comes from a ``torch.Generator`` or is
handed in, so that tests can replay the JAX package's draw. The decoder
blocks run plain PyTorch attention, as the RoI heads' do.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ..parallel.mesh import global_count
from .heads import _decoder_pos_embed
from .layers import Block, Dense, LayerNorm

__all__ = ["MAEDecoderHead", "patchify"]


def patchify(imgs: torch.Tensor, p: int = 16) -> torch.Tensor:
    """(B, H, W, 3) -> (B, (H/p)*(W/p), p*p*3), MAE's patch order."""
    b, h, w, c = imgs.shape
    x = imgs.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


class MAEDecoderHead(nn.Module):
    def __init__(self, in_channels: int = 384, embed_dim: int = 256, depth: int = 4,
                 num_heads: int = 8, mlp_ratio: float = 4.0, patch_size: int = 16,
                 base_grid: int = 14, mask_ratio: float = 0.75, norm_pix_loss: bool = True,
                 loss_weight: float = 1.0):
        super().__init__()
        self.embed_dim, self.patch_size, self.base_grid = embed_dim, patch_size, base_grid
        self.mask_ratio, self.norm_pix_loss, self.loss_weight = mask_ratio, norm_pix_loss, loss_weight
        self.norm = LayerNorm(in_channels)
        self.decoder_embed = Dense(in_channels, embed_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.decoder_blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, use_kernel=False) for _ in range(depth))
        self.decoder_norm = LayerNorm(embed_dim)
        self.decoder_pred = Dense(embed_dim, patch_size**2 * 3)

    def forward(self, tokens, img, generator=None, noise=None):
        """tokens (B, 1 + N, Din) encoder output (cls + patch tokens); img
        (B, H, W, 3) the normalised input; ``noise`` optional (B, N)
        uniforms that order the masking, in place of the generator's.
        Returns the scalar reconstruction loss."""
        b, n1, _ = tokens.shape
        n, d = n1 - 1, self.embed_dim
        h, w = img.shape[1:3]
        ps = self.patch_size
        len_keep = int(n * (1.0 - self.mask_ratio))
        if noise is None:
            noise = torch.rand((b, n), generator=generator, device=tokens.device)
        ids_shuffle = torch.argsort(noise.to(tokens.device), dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        mask = torch.ones((b, n), device=tokens.device)
        mask[:, :len_keep] = 0.0
        mask = torch.gather(mask, 1, ids_restore)  # 1 = masked

        x = self.decoder_embed(self.norm(tokens))
        vis = torch.gather(x[:, 1:], 1, ids_shuffle[:, :len_keep, None].expand(b, len_keep, d))
        x_ = torch.cat([vis, self.mask_token.expand(b, n - len_keep, d).to(x.dtype)], dim=1)
        x_ = torch.gather(x_, 1, ids_restore[..., None].expand(b, n, d))  # unshuffle
        x = torch.cat([x[:, :1], x_], dim=1)
        pos = _decoder_pos_embed(d, self.base_grid, h // ps, w // ps)
        x = x + pos.to(device=x.device, dtype=x.dtype)
        for blk in self.decoder_blocks:
            x, _ = blk(x)
        pred = self.decoder_pred(self.decoder_norm(x)[:, 1:])  # (B, N, p*p*3)

        # target: back to [0, 1], then each patch normalised
        mean = img.new_tensor(IMAGENET_MEAN / 255.0)
        std = img.new_tensor(IMAGENET_STD / 255.0)
        target = patchify(img.float() * std + mean, ps)
        if self.norm_pix_loss:
            mu = target.mean(-1, keepdim=True)
            var = target.var(-1, keepdim=True, unbiased=False)
            target = (target - mu) / torch.sqrt(var + 1e-6)
        loss = ((pred.float() - target) ** 2).mean(-1)  # (B, N)
        loss = (loss * mask).sum() / global_count(mask.sum())
        return self.loss_weight * loss
