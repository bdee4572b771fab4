"""FPN neck (stock mmdet ``FPN`` semantics, channel-last).

Port of ``attentionshift_tpu/models/fpn.py``: 1x1 lateral convs (a
``Dense`` over the channel-last axis),
nearest-neighbour top-down addition, 3x3 output convs (as shifted
matmuls), and extra stride-2 subsampled levels up to ``num_outs``. In the
AttnShift detector it feeds only the RPN; in the Mask R-CNN every head.
Convs are Xavier-uniform initialised, as mmdet's.

``in_channels`` is one width for every level (the ViT's taps) or one per
level, fine to coarse ((256, 512, 1024, 2048) for ResNet-50); the flax
module infers it from its inputs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import Conv3x3Matmul, Dense

__all__ = ["FPN"]


def _upsample_nearest2x(x):
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, h * 2, w * 2, c)


class FPN(nn.Module):
    def __init__(self, in_channels: int | Sequence[int] = 384, out_channels: int = 256,
                 num_ins: int = 4, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        widths = [in_channels] * num_ins if isinstance(in_channels, int) else list(in_channels)
        if len(widths) != num_ins:
            raise ValueError(f"FPN: {len(widths)} input widths for {num_ins} levels")
        self.lateral = nn.ModuleList(Dense(cin, out_channels) for cin in widths)
        self.fpn_conv = nn.ModuleList(Conv3x3Matmul(out_channels, out_channels)
                                      for _ in range(num_ins))
        self.reset_parameters()

    def reset_parameters(self):
        for conv in self.lateral:
            cout, cin = conv.weight.shape
            bound = (6.0 / (cin + cout)) ** 0.5
            with torch.no_grad():
                conv.weight.uniform_(-bound, bound)
                conv.bias.zero_()
        for conv in self.fpn_conv:
            _, _, cin, cout = conv.weight.shape
            bound = (6.0 / (9 * cin + 9 * cout)) ** 0.5
            with torch.no_grad():
                conv.weight.uniform_(-bound, bound)
                conv.bias.zero_()

    def forward(self, inputs):
        """inputs: (B, H_i, W_i, C) maps, fine -> coarse, each exactly 2x the
        next one's resolution. Returns ``num_outs`` maps."""
        laterals = [conv(x) for conv, x in zip(self.lateral, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_nearest2x(laterals[i])
        outs = [conv(x) for conv, x in zip(self.fpn_conv, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, ::2, ::2, :])
        return tuple(outs)
