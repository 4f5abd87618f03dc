"""VoVNet(V2) image backbone, port of ``stereoscene_tpu/models/vovnet.py``
(ref: models/backbones/vovnet.py): one-shot aggregation blocks (a chain of
3x3 conv-BN-ReLU whose outputs are all concatenated and fused by a 1x1
one), effective squeeze-excite, an identity residual on a stage's later
blocks; a /4 stem and four stages at strides 4, 8, 16, 32, joined by a
3x3 stride-2 max pool with TF-SAME padding. Channels-first; keys follow
the JAX module names.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm


class ConvBN(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride=stride,
                              padding=kernel // 2, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ESE(nn.Module):
    """Effective squeeze-excite: an fp32 global mean, one fc, a sigmoid
    gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Linear(channels, channels)

    def forward(self, x):
        pooled = x.float().mean(dim=(2, 3)).to(x.dtype)
        return x * torch.sigmoid(self.fc(pooled))[:, :, None, None]


class OSABlock(nn.Module):
    def __init__(self, cin: int, stage_channels: int, concat_channels: int,
                 num_convs: int = 5, identity: bool = False):
        super().__init__()
        self.num_convs = num_convs
        self.identity = identity
        c = cin
        for i in range(num_convs):
            setattr(self, f"conv{i}", ConvBN(c, stage_channels))
            c = stage_channels
        self.concat_conv = ConvBN(cin + num_convs * stage_channels,
                                  concat_channels, kernel=1)
        self.ese = ESE(concat_channels)

    def forward(self, x):
        feats = [x]
        y = x
        for i in range(self.num_convs):
            y = getattr(self, f"conv{i}")(y)
            feats.append(y)
        y = self.ese(self.concat_conv(torch.cat(feats, dim=1)))
        if self.identity and x.shape == y.shape:
            y = y + x
        return y


def _max_pool_same(x):
    """3x3 stride-2 max pool with TF-SAME padding (-inf)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, stride=2)


class VoVNet(nn.Module):
    """VoVNet-39-ish: [N, 3, H, W] -> the stages of ``out_indices``."""

    def __init__(self, stage_channels: Sequence[int] = (128, 160, 192, 224),
                 concat_channels: Sequence[int] = (256, 512, 768, 1024),
                 blocks_per_stage: Sequence[int] = (1, 1, 2, 2),
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 in_channels: int = 3):
        super().__init__()
        self.blocks = tuple(blocks_per_stage)
        self.out_indices = tuple(out_indices)
        self.stem1 = ConvBN(in_channels, 64, stride=2)
        self.stem2 = ConvBN(64, 64)
        self.stem3 = ConvBN(64, 128, stride=2)
        cin = 128
        for s, (sc, cc, n) in enumerate(zip(stage_channels, concat_channels,
                                            blocks_per_stage)):
            for i in range(n):
                setattr(self, f"stage{s}_osa{i}",
                        OSABlock(cin, sc, cc, identity=i > 0))
                cin = cc

    def forward(self, x):
        x = self.stem3(self.stem2(self.stem1(x)))
        outs = []
        for s, n in enumerate(self.blocks):
            if s > 0:
                x = _max_pool_same(x)
            for i in range(n):
                x = getattr(self, f"stage{s}_osa{i}")(x)
            if s in self.out_indices:
                outs.append(x)
        return tuple(outs)
