"""RoI heads: MIL layer selection, ViT-decoder box head, point-sup mask head.

Port of ``attentionshift_tpu/models/heads.py``:

- ``MILHead``: WSDDN-style two-branch MIL over the per-layer candidate
  boxes: RoI features of all (instance, layer) candidates -> per-instance
  best layer and the binary-CE bag loss. The bag softmax/log chain runs
  in f32 (a bf16 clip at 1 - 1e-6 rounds to 1.0 and makes log(0)).
- ``BoxHeadRec``: 4-block ViT decoder over 7x7 RoI tokens with a det
  token; softmax classification + class-wise box regression, GIoU loss
  on the decoded boxes; with ``with_reconstruct`` also a per-patch RGB
  prediction of each RoI token (``fc_rec``), which
  ``reconstruction_loss`` holds against the normalised image crop.
- ``MaskHeadPointSup``: 4-block ViT decoder over 14x14 RoI tokens with a
  fixed sin-cos position embedding, x2 bicubic upsample, 1x1 conv to
  per-class 28x28 logits; ``mask_point_loss`` is BCE at sampled points
  (target label 2 = ignore).

The decoder blocks (256 wide, 8 heads of 32) run plain PyTorch attention
with autograd by default. ``use_kernel=True`` (the JAX heads'
``use_pallas``) runs them on the attention kernels' head-dim-32 instance
instead (``attention_no_capture``: the flash pass forward, the backward
pair); the detector leaves it off, as the JAX detector leaves
``use_pallas`` off for its heads.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.boxes import delta2bbox
from ..core.losses import giou_loss, softmax_cross_entropy
from ..ops.image import resize
from ..ops.roi_align import roi_align
from ..parallel.mesh import global_count
from .layers import Block, Dense, LayerNorm, get_2d_sincos_pos_embed

__all__ = ["MILHead", "BoxHeadRec", "MaskHeadPointSup", "mask_point_loss", "reconstruction_loss"]


def _decoder_pos_embed(embed_dim: int, base_grid: int, hp: int, wp: int) -> torch.Tensor:
    """Fixed sin-cos pos embed stored at ``base_grid`` and bicubic-resized
    to the RoI grid: (1 + hp*wp, D), cls row first."""
    pe = torch.from_numpy(get_2d_sincos_pos_embed(embed_dim, base_grid, cls_token=True))
    cls, patch = pe[:1], pe[1:]
    if (hp, wp) != (base_grid, base_grid):
        grid = patch.reshape(base_grid, base_grid, embed_dim).permute(2, 0, 1)
        patch = resize(grid, (hp, wp), method="bicubic").permute(1, 2, 0).reshape(hp * wp, embed_dim)
    return torch.cat([cls, patch], dim=0)


class _RoIDecoder(nn.Module):
    """What the two decoder heads share: norm + embed of the RoI tokens,
    the decoder blocks and the final norm."""

    def __init__(self, in_channels, embed_dim, depth, num_heads, mlp_ratio, base_grid,
                 use_kernel=False):
        super().__init__()
        self.embed_dim, self.base_grid = embed_dim, base_grid
        if in_channels != embed_dim:
            self.norm = LayerNorm(in_channels)
            self.decoder_embed = Dense(in_channels, embed_dim)
        self.decoder_blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, use_kernel=use_kernel) for _ in range(depth))
        self.decoder_box_norm = LayerNorm(embed_dim)
        self._pos = {}

    def _embed(self, roi_feats):
        r, s, _, cin = roi_feats.shape
        x = roi_feats.reshape(r, s * s, cin)
        if hasattr(self, "norm"):
            x = self.decoder_embed(self.norm(x))
        return x

    def _pos_embed(self, s, like):
        key = (s, like.device, like.dtype)
        if key not in self._pos:
            self._pos[key] = _decoder_pos_embed(self.embed_dim, self.base_grid, s, s).to(
                device=like.device, dtype=like.dtype)
        return self._pos[key]

    def _decode(self, x):
        for blk in self.decoder_blocks:
            x, _ = blk(x)
        return self.decoder_box_norm(x)


class MILHead(nn.Module):
    def __init__(self, num_classes: int = 20, in_channels: int = 384, embed_dim: int = 256,
                 hidden_dim: int = 1024, roi_size: int = 7, loss_mil_factor: float = 1.0):
        super().__init__()
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.loss_mil_factor = loss_mil_factor
        if in_channels != embed_dim:
            self.norm = LayerNorm(in_channels)
            self.decoder_embed = Dense(in_channels, embed_dim)
        self.fc1 = Dense(roi_size * roi_size * embed_dim, hidden_dim)
        self.fc2 = Dense(hidden_dim, hidden_dim)
        self.classification_branch = Dense(hidden_dim, num_classes)
        self.proposal_branch = Dense(hidden_dim, num_classes)

    def forward(self, roi_feats, gt_labels, valid):
        """roi_feats (G, L, S, S, Cin), gt_labels (G,), valid (G,) ->
        best layer (G,) int32, scalar bag loss (padding excluded)."""
        g, l, s, _, cin = roi_feats.shape
        x = roi_feats.reshape(g * l, s * s, cin)
        if hasattr(self, "norm"):
            x = self.decoder_embed(self.norm(x))
        x = x.reshape(g * l, s * s * self.embed_dim)
        x = F.relu(self.fc2(F.relu(self.fc1(x))))
        c = self.num_classes
        cls = torch.softmax(self.classification_branch(x).reshape(g, l, c).float(), dim=-1)
        prop = torch.softmax(self.proposal_branch(x).reshape(g, l, c).float(), dim=-2)
        bag = cls * prop
        bag_cls = torch.gather(bag, 2, gt_labels.long()[:, None, None].expand(g, l, 1))[..., 0]
        best = torch.argmax(bag_cls, dim=-1).int()
        bag_sum = bag.sum(dim=1).clamp(1e-6, 1.0 - 1e-6)
        onehot = F.one_hot(gt_labels.long(), c).float()
        loss = -(onehot * torch.log(bag_sum) + (1.0 - onehot) * torch.log(1.0 - bag_sum))
        loss = torch.where(valid.bool()[:, None], loss, 0.0)
        denom = global_count(valid.float().sum() * c)
        return best, self.loss_mil_factor * loss.sum() / denom


class BoxHeadRec(_RoIDecoder):
    """ViT-decoder box head."""

    def __init__(self, num_classes: int = 20, in_channels: int = 384, embed_dim: int = 256,
                 depth: int = 4, num_heads: int = 8, mlp_ratio: float = 4.0, base_grid: int = 14,
                 with_reconstruct: bool = False, patch_size: int = 16, use_kernel: bool = False):
        super().__init__(in_channels, embed_dim, depth, num_heads, mlp_ratio, base_grid,
                         use_kernel)
        self.num_classes = num_classes
        self.det_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.fc_cls = Dense(embed_dim, num_classes + 1)
        self.fc_reg = Dense(embed_dim, 4 * num_classes)
        if with_reconstruct:
            self.fc_rec = Dense(embed_dim, 3 * patch_size**2)

    def forward(self, roi_feats):
        """(R, S, S, Cin) RoI features -> cls_score (R, num_classes + 1)
        logits, bbox_pred (R, num_classes*4) deltas, and the reconstruction
        (R, S, S, 3*patch^2) with ``with_reconstruct``, else None."""
        r, s = roi_feats.shape[:2]
        x = self._embed(roi_feats)
        x = torch.cat([self.det_token.expand(r, 1, -1).to(x.dtype), x], dim=1)
        x = self._decode(x + self._pos_embed(s, x))
        rec = self.fc_rec(x[:, 1:]).reshape(r, s, s, -1) if hasattr(self, "fc_rec") else None
        return self.fc_cls(x[:, 0]), self.fc_reg(x[:, 0]), rec

    def loss(self, cls_score, bbox_pred, rois, labels, label_weights, bbox_targets, bbox_weights,
             target_stds=(0.1, 0.1, 0.2, 0.2), bbox_loss_weight: float = 10.0, loss_enable=1.0):
        """Classification + GIoU-on-decoded-boxes loss; padding rows carry
        ``label_weights == 0``."""
        cls_score, bbox_pred = cls_score.float(), bbox_pred.float()
        labels = labels.long()
        avg = global_count((label_weights > 0).sum().float())
        losses = {"loss_cls": softmax_cross_entropy(cls_score, labels, weight=label_weights,
                                                    avg_factor=avg) * loss_enable}
        correct = (cls_score.argmax(dim=-1) == labels) & (label_weights > 0)
        losses["acc"] = 100.0 * correct.sum() / avg
        pos = (labels >= 0) & (labels < self.num_classes) & (bbox_weights[:, 0] > 0)
        sel = labels.clamp(0, self.num_classes - 1)[:, None, None].expand(-1, 1, 4)
        sel_pred = torch.gather(bbox_pred.reshape(bbox_pred.shape[0], -1, 4), 1, sel)[:, 0]
        decoded = delta2bbox(rois, sel_pred, stds=target_stds)
        # the row count is the same on every rank, so it needs no reduction:
        # B*S here is the global count's share per rank
        lb = giou_loss(decoded, bbox_targets, weight=pos.float(), avg_factor=float(labels.shape[0]))
        losses["loss_bbox"] = bbox_loss_weight * lb * loss_enable
        return losses


class MaskHeadPointSup(_RoIDecoder):
    """ViT-decoder mask head."""

    def __init__(self, num_classes: int = 20, in_channels: int = 384, embed_dim: int = 256,
                 depth: int = 4, num_heads: int = 8, mlp_ratio: float = 4.0, base_grid: int = 14,
                 scale_factor: int = 2, scale_mode: str = "bicubic", use_kernel: bool = False):
        super().__init__(in_channels, embed_dim, depth, num_heads, mlp_ratio, base_grid,
                         use_kernel)
        self.scale_factor, self.scale_mode = scale_factor, scale_mode
        self.conv_logits = Dense(embed_dim, num_classes)

    def forward(self, roi_feats):
        """(R, S, S, Cin) RoI features -> (R, sf*S, sf*S, num_classes)."""
        r, s = roi_feats.shape[:2]
        x = self._embed(roi_feats)
        x = self._decode(x + self._pos_embed(s, x)[1:]).reshape(r, s, s, self.embed_dim)
        up = s * self.scale_factor
        x = resize(x.permute(0, 3, 1, 2), (up, up), method=self.scale_mode, align_corners=True)
        return self.conv_logits(x.permute(0, 2, 3, 1))


def reconstruction_loss(rec_pred, rois, img, roi_valid, patch_size: int = 16,
                        rec_weight: float = 1.0):
    """The per-patch normalised-pixel MSE of ``BoxHeadRec``'s
    reconstruction: rec_pred (R, S, S, 3*patch^2) against the crop of the
    normalised images img (B, H, W, 3) at rois (R, 5) [batch_idx, xyxy],
    taken at S*patch pixels a side, each patch normalised by its own mean
    and variance (layout (patch*patch, 3) per patch); averaged over the
    rows where roi_valid (R,)."""
    r, s = rec_pred.shape[:2]
    p = patch_size
    crop = roi_align(img.permute(0, 3, 1, 2).float(), rois, spatial_scale=1.0,
                     output_size=s * p).permute(0, 2, 3, 1)  # (R, S*p, S*p, 3)
    tgt = crop.reshape(r, s, p, s, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(r, s, s, p * p, 3)
    mu = tgt.mean(dim=3, keepdim=True)
    var = tgt.var(dim=3, keepdim=True, unbiased=False)
    tgt = ((tgt - mu) / torch.sqrt(var + 1e-6)).reshape(r, s, s, 3 * p * p)
    err = ((rec_pred.float() - tgt) ** 2).mean(dim=(1, 2, 3))
    err = torch.where(roi_valid.bool(), err, 0.0)
    return rec_weight * err.sum() / global_count(roi_valid.sum().float())


def mask_point_loss(point_preds, point_targets, labels, pos_valid, loss_enable=1.0):
    """BCE at sampled points with ignore label 2. point_preds (R, P, C)
    sampled logits; point_targets (R, P) in {0, 1, 2}; labels (R,) class
    per RoI; pos_valid (R,) real positive RoIs. Ignored points still
    count in the denominator, padded rows do not."""
    logits = torch.gather(point_preds.float(), 2,
                          labels.long()[:, None, None].expand(-1, point_preds.shape[1], 1))[..., 0]
    ignore = point_targets == 2
    tgt = torch.where(ignore, 0.0, point_targets.float())
    bce = logits.clamp_min(0) - logits * tgt + torch.log1p(torch.exp(-logits.abs()))
    bce = torch.where(~ignore & pos_valid.bool()[:, None], bce, 0.0)
    denom = global_count((pos_valid.sum() * point_targets.shape[1]).float())
    return (bce.sum() / denom) * loss_enable
