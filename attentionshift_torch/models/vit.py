"""ViT detection backbone with point tokens and attention capture.

Port of ``attentionshift_tpu/models/vit.py``: patchify + cls token +
bicubic-interpolated pos embed, 100 learnable point tokens appended
after the patch tokens, head-averaged attention captured from the
trailing ``capture_layers`` blocks (in the model dtype), DETR-style MLP
heads on the point tokens, and, when asked, the 4-scale feature taps.

``pad_tokens_to`` inserts zero tokens BETWEEN the patch and point tokens
so the token axis is a multiple of it; the gap ``[1 + n_patch, 1 +
n_patch + n_pad)`` is masked out of every softmax, so the point tokens
stay the last P rows and every consumer is unchanged. Layout is
channel-last, as in the JAX package.

The training forward (``deterministic=False``) adds drop path at rates
``linspace(0, drop_path_rate, depth)`` and, with ``use_remat``, runs each
block under ``torch.utils.checkpoint``: the block's activations are
recomputed in the backward pass. The recompute runs the attention
without the probability output (the captured matrix was already taken
in the first forward), and sees the same drop-path masks, which are
drawn before the block runs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import BatchNorm, Block, Deconv2x2Matmul, Dense, PatchEmbed, interpolate_pos_embed

__all__ = ["MlpHead", "VisionTransformerDet"]


class MlpHead(nn.Module):
    """3-layer relu MLP."""

    def __init__(self, dim: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        dims = [dim] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


def _capture_once(blk, capture: bool, pad_interval, masks):
    """``blk`` as a function of x for ``checkpoint``: its first call
    captures (when asked); the recompute in the backward pass runs with
    ``capture=False``, since the captured matrix was already taken."""
    calls = [0]

    def run(x):
        calls[0] += 1
        return blk(x, capture and calls[0] == 1, pad_interval, masks)

    return run


class VisionTransformerDet(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, out_indices=(3, 5, 7, 11), point_tokens_num: int = 100,
                 num_classes: int = 20, capture_layers: int = 7, pad_tokens_to: int = 0,
                 drop_path_rate: float = 0.0, use_remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = embed_dim
        grid = img_size // patch_size
        self.patch_size = patch_size
        self.embed_dim = d
        self.out_indices = tuple(out_indices)
        self.point_tokens_num = point_tokens_num
        self.capture_layers = capture_layers
        self.pad_tokens_to = pad_tokens_to
        self.dtype = dtype
        self.use_remat = use_remat
        self.drop_path_rate = drop_path_rate
        dpr = np.linspace(0.0, drop_path_rate, depth).tolist()
        self.patch_embed = PatchEmbed(d, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, d))
        self.point_token = nn.Parameter(torch.zeros(1, point_tokens_num, d))
        self.point_pos_embed = nn.Parameter(torch.zeros(1, point_tokens_num, d))
        self.blocks = nn.ModuleList(Block(d, num_heads, mlp_ratio, qkv_bias, dpr[i])
                                    for i in range(depth))
        self.fpn1_deconv1 = Deconv2x2Matmul(d, d)
        self.fpn1_bn = BatchNorm(d)
        self.fpn1_deconv2 = Deconv2x2Matmul(d, d)
        self.fpn2_deconv = Deconv2x2Matmul(d, d)
        self.class_embed = MlpHead(d, d, num_classes)
        self.bbox_embed = MlpHead(d, d, 2)

    def draw_drop_masks(self, batch: int, device, generator=None):
        """(depth, 2, B) Bernoulli(1 - rate_i) keep masks of one training
        forward, or None when the model has no drop path."""
        if self.drop_path_rate == 0.0:
            return None
        keep = torch.tensor([1.0 - blk.drop_path for blk in self.blocks], device=device)
        return torch.bernoulli(keep[:, None, None].expand(-1, 2, batch), generator=generator)

    def forward(self, img: torch.Tensor, with_features: bool = False,
                deterministic: bool = True, generator=None, drop_masks=None,
                capture: bool = True) -> dict:
        """img: (B, H, W, 3), H and W divisible by the patch size.

        ``capture=False`` runs every block without the probability output
        (``attns`` is then None): the test path, which reads no attention.

        ``deterministic=False`` is the training forward: drop path from
        ``drop_masks`` ((depth, 2, B) keep masks) or, without them, drawn
        from ``generator``; activation checkpointing when ``use_remat``;
        the feature pyramid always produced.

        Returns a dict, channel-last: point_tokens (B, P, D),
        outputs_class (B, P, C), outputs_coord (B, P, 2) in [0, 1], attns
        (capture_layers, B, T, T) in the model dtype, last_feat
        (B, 1 + Hp*Wp, D); with ``with_features`` also org_feats
        (B, 4, Hp, Wp, D) and feature, the 4-scale pyramid
        (B, H/4, W/4, D) ... (B, H/32, W/32, D).
        """
        b, h, w, _ = img.shape
        hp, wp = h // self.patch_size, w // self.patch_size
        n_patch = hp * wp
        p, d = self.point_tokens_num, self.embed_dim

        x = self.patch_embed(img.to(self.dtype)).reshape(b, n_patch, d)
        x = torch.cat([self.cls_token.expand(b, 1, d).to(x.dtype), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, hp, wp).to(x.dtype)
        pts = (self.point_token + self.point_pos_embed).to(x.dtype)
        pad_interval = None
        if self.pad_tokens_to:
            n_pad = -(1 + n_patch + p) % self.pad_tokens_to
            if n_pad:
                pad_interval = (1 + n_patch, 1 + n_patch + n_pad)
                x = torch.cat([x, x.new_zeros(b, n_pad, d)], dim=1)
        x = torch.cat([x, pts.expand(b, p, d)], dim=1)

        capture_from = len(self.blocks) - (self.capture_layers if capture else 0)
        if deterministic:
            drop_masks = None
        else:
            with_features = True
            if drop_masks is None:
                drop_masks = self.draw_drop_masks(b, x.device, generator)
        remat = self.use_remat and not deterministic and torch.is_grad_enabled()
        attns, feats = [], []
        for i, blk in enumerate(self.blocks):
            masks = None if drop_masks is None else drop_masks[i]
            if remat:
                x, attn = checkpoint(_capture_once(blk, i >= capture_from, pad_interval, masks),
                                     x, use_reentrant=False, preserve_rng_state=False)
            else:
                x, attn = blk(x, i >= capture_from, pad_interval, masks)
            if attn is not None:
                attns.append(attn)
            if with_features and i in self.out_indices:
                feats.append(x[:, 1:1 + n_patch].reshape(b, hp, wp, d))

        point_tokens = x[:, x.shape[1] - p:]
        ret = dict(
            point_tokens=point_tokens,
            last_feat=x[:, :1 + n_patch],
            attns=torch.stack(attns, dim=0) if attns else None,
            outputs_class=self.class_embed(point_tokens),
            outputs_coord=torch.sigmoid(self.bbox_embed(point_tokens)),
        )
        if with_features:
            ret["org_feats"] = torch.stack(feats, dim=1)
            f0 = self.fpn1_deconv2(F.gelu(self.fpn1_bn(self.fpn1_deconv1(feats[0]))))
            f3 = F.max_pool2d(feats[3].permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            ret["feature"] = (f0, self.fpn2_deconv(feats[1]), feats[2], f3)
        return ret
