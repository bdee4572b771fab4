"""MIL layer-selection head.

Port of ``MILHead`` (``attentionshift_tpu/models/heads.py:66-126``), a
WSDDN-style two-branch MIL over the per-layer candidate boxes: RoI
features of all (instance, layer) candidates -> per-instance best layer
and the binary-CE bag loss. The bag softmax/log chain runs in f32 (a
bf16 clip at 1 - 1e-6 rounds to 1.0 and makes log(0)).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense, LayerNorm

__all__ = ["MILHead"]


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
        denom = (valid.float().sum() * c).clamp_min(1.0)
        return best, self.loss_mil_factor * loss.sum() / denom
