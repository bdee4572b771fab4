"""ResNet backbone (channel-last in and out, frozen-BN detection flavour).

Port of ``attentionshift_tpu/models/resnet.py``, the stock mmdetection
ResNet that the refinement stage's Mask R-CNN (AttnShift-dagger) builds
on. Detection practice keeps BatchNorm in eval mode with frozen affine
parameters (mmdet ``norm_eval=True`` + ``requires_grad=False``): a
per-channel affine constant, ``FrozenBN``, whose four vectors are buffers
that no optimizer sees.

The stem and the stages up to ``frozen_stages`` never train: their
parameters are made ``requires_grad=False``, which gives every other
parameter the gradient that the JAX package's ``stop_gradient`` cuts on
the activations give it, and those parameters none.

Layout: parameter names follow torchvision's ResNet (``conv1``, ``bn1``,
``layer{s}.{b}.conv{1,2,3}``, ``bn{1,2,3}``, ``downsample.{0,1}``); conv
weights are (Cout, Cin, kh, kw). The convolutions are ``F.conv2d`` (cuDNN
on the card), the counterparts of the JAX module's XLA convolutions; they
run on the NHWC input permuted to NCHW, which is channels-last memory.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ResNet", "Bottleneck", "FrozenBN"]


class FrozenBN(nn.Module):
    """BatchNorm folded to a frozen per-channel affine transform over
    axis 1 (NCHW): ``x * w / sqrt(var + eps) + (b - mean * w / sqrt(var + eps))``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        std = torch.sqrt(self.running_var + self.eps)
        mul = (self.weight / std).to(x.dtype)
        add = (self.bias - self.running_mean * self.weight / std).to(x.dtype)
        return x * mul[:, None, None] + add[:, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) with a projection shortcut on the
    first block of a stage (style 'pytorch': the stride sits on the 3x3)."""

    def __init__(self, cin: int, features: int, stride: int = 1, project: bool = False):
        super().__init__()
        f = features
        self.conv1 = nn.Conv2d(cin, f, 1, bias=False)
        self.bn1 = FrozenBN(f)
        self.conv2 = nn.Conv2d(f, f, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBN(f)
        self.conv3 = nn.Conv2d(f, 4 * f, 1, bias=False)
        self.bn3 = FrozenBN(4 * f)
        # flax 'SAME' pads nothing for a 1x1 kernel, whatever the stride
        self.downsample = (nn.Sequential(nn.Conv2d(cin, 4 * f, 1, stride=stride, bias=False),
                                         FrozenBN(4 * f)) if project else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNet(nn.Module):
    """ResNet-{50,101,...} returning the (C2, C3, C4, C5) pyramid.

    ``frozen_stages=1`` freezes the stem and ``layer1``; any value >= 0
    freezes the stem, as the JAX module's first ``stop_gradient`` does.
    """

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3), base_width: int = 64,
                 frozen_stages: int = 1):
        super().__init__()
        self.depths, self.frozen_stages = tuple(depths), frozen_stages
        self.conv1 = nn.Conv2d(3, base_width, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(base_width)
        cin = base_width
        self.out_channels = []
        for stage, blocks in enumerate(self.depths):
            f = base_width * 2**stage
            layer = nn.Sequential(*(
                Bottleneck(cin if blk == 0 else 4 * f, f,
                           stride=2 if (blk == 0 and stage > 0) else 1, project=blk == 0)
                for blk in range(blocks)))
            setattr(self, f"layer{stage + 1}", layer)
            cin = 4 * f
            self.out_channels.append(cin)
        if frozen_stages >= 0:
            self.conv1.requires_grad_(False)
        for stage in range(1, min(frozen_stages, len(self.depths)) + 1):
            getattr(self, f"layer{stage}").requires_grad_(False)

    def forward(self, img):
        """img: (B, H, W, 3) normalised; H, W divisible by 32. Returns 4 maps
        (B, H/4, W/4, 4 * base) ... (B, H/32, W/32, 32 * base), channel-last."""
        x = img.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x.to(self.conv1.weight.dtype))))
        # torch maxpool(3, stride 2, pad 1): the JAX module pads with -inf
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in range(len(self.depths)):
            x = getattr(self, f"layer{stage + 1}")(x)
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
