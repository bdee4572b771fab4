"""Dynamic-filter keypoint-align head (CondInst-style).

Port of ``attentionshift_tpu/models/condinst.py``: each instance token
generates, through a linear ``controller``, the weights of a small
per-instance MLP; the part features are projected by a shared MLP
(``part_feature_head``) and scored by every instance's network; the loss
is a cross-entropy over the instances for each part
(``loss_keypoint_align``, weight 0.1). The part projection's width equals
the dynamic width (``feat_channels``). Invalid parts give no loss;
invalid instances are masked out of the softmax. The head computes in
f32, as flax's ``Dense`` does for a bf16 input and f32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import global_count
from .layers import Dense

__all__ = ["SimpleCondInstHead"]


class _MLP(nn.Module):
    """ReLU MLP: ``num_layers`` linear layers (flax ``Dense_i`` -> ``layers.i``)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class SimpleCondInstHead(nn.Module):
    def __init__(self, token_channels: int, part_channels: int, feat_channels: int = 8,
                 num_layers: int = 3, mlp_hidden: int = 256, mlp_num_layers: int = 3,
                 loss_weight: float = 0.1):
        super().__init__()
        c = feat_channels
        self.feat_channels, self.num_layers, self.loss_weight = c, num_layers, loss_weight
        out_dims = [c] * (num_layers - 1) + [1]
        self.w_sizes = [o * c for o in out_dims]
        self.b_sizes = out_dims
        self.controller = Dense(token_channels, sum(self.w_sizes) + sum(self.b_sizes))
        self.part_feature_head = _MLP(part_channels, mlp_hidden, c, mlp_num_layers)

    def forward(self, token_feats, part_feats, part_labels, part_valid, token_valid) -> dict:
        """token_feats (..., N, Dt) instance tokens; part_feats (..., P, Dp);
        part_labels (..., P) owning instance slot; part_valid (..., P);
        token_valid (..., N). Returns ``{"loss_keypoint_align": loss}``."""
        lead = token_feats.shape[:-2]
        n, p, c = token_feats.shape[-2], part_feats.shape[-2], self.feat_channels
        params = self.controller(token_feats.float())  # (..., N, S)
        x = self.part_feature_head(part_feats.float())[..., None, :, :, None].expand(
            *lead, n, p, c, 1)
        chunks = params.split(self.w_sizes + self.b_sizes, dim=-1)
        for i in range(self.num_layers):
            out_dim = self.b_sizes[i]
            w = chunks[i].reshape(*lead, n, 1, out_dim, c)
            bias = chunks[self.num_layers + i].reshape(*lead, n, 1, out_dim, 1)
            x = torch.matmul(w, x) + bias  # (..., N, P, out, 1)
            if i < self.num_layers - 1:
                x = F.relu(x)
        logits = x[..., 0, 0].transpose(-1, -2)  # (..., P, N)
        logits = torch.where(token_valid.bool()[..., None, :], logits, -1e9)
        logp = torch.log_softmax(logits, dim=-1)
        tgt = part_labels.long().clamp(0, n - 1)
        ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
        valid = part_valid.bool() & torch.gather(token_valid.bool(), -1, tgt)
        loss = -(ll * valid).sum() / global_count(valid.sum().float())
        return {"loss_keypoint_align": loss * self.loss_weight}
