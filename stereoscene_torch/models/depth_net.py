"""Camera-aware monocular depth net, port of
``stereoscene_tpu/models/depth_net.py``
(ref: ViewTransformerLSSBEVDepth.py:343-517).

GN(2)-normalised camera embedding, SE-conditioned context and depth paths;
depth path = 3 BasicBlocks -> ASPP (dilations 1/6/12/18 + pooled branch)
-> DCNv1 (groups 4, zero-init offset conv; the P1 kernel on the card)
-> 1x1 to D logits. Output is the channel concat [depth logits | context].
The ASPP branches are plain dilated convolutions (the JAX package's
tap-matmul lowering is a TPU layout choice for the same math). In training
mode the ASPP output goes through dropout at rate 0.5 (depth_net.py:137 of
the JAX package).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import deform_conv2d
from .layers import BatchNorm, GroupNorm, Mlp, SELayer, dropout


class BasicBlock2d(nn.Module):
    """mmdet ResNet BasicBlock (stride 1, same width)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(c)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(c)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class _ASPPModule(nn.Module):
    def __init__(self, cin, cout, k, padding, dilation):
        super().__init__()
        self.atrous_conv = nn.Conv2d(cin, cout, k, padding=padding,
                                     dilation=dilation, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    def __init__(self, cin: int, mid: int, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.aspp1 = _ASPPModule(cin, mid, 1, 0, 1)
        self.aspp2 = _ASPPModule(cin, mid, 3, 6, 6)
        self.aspp3 = _ASPPModule(cin, mid, 3, 12, 12)
        self.aspp4 = _ASPPModule(cin, mid, 3, 18, 18)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)),
            nn.Conv2d(cin, mid, 1, bias=False),
            GroupNorm(2, mid), nn.ReLU())
        self.conv1 = nn.Conv2d(mid * 5, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)

    def forward(self, x, generator=None):
        xs = [self.aspp1(x), self.aspp2(x), self.aspp3(x), self.aspp4(x)]
        g = self.global_avg_pool(x)  # [N, mid, 1, 1], a constant map
        xs.append(g.expand(-1, -1, *xs[0].shape[-2:]))
        y = F.relu(self.bn1(self.conv1(torch.cat(xs, dim=1))))
        if self.training and self.dropout_rate > 0:
            y = dropout(y, self.dropout_rate, generator)
        return y


class DeformConvPack(nn.Module):
    """mmcv DeformConv2dPack (DCNv1, 3x3, groups 4, no bias): offsets from
    the zero-initialised internal ``conv_offset``."""

    def __init__(self, c: int, groups: int = 4):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(c, c // groups, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.conv_offset = nn.Conv2d(c, 18, 3, padding=1)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x, use_kernel=None):
        """``use_kernel`` goes to ``ops.deform_conv.deform_conv2d`` (P1)."""
        offsets = self.conv_offset(x).permute(0, 2, 3, 1)
        cout, cing = self.weight.shape[:2]
        taps = self.weight.reshape(cout, cing, 9).permute(2, 1, 0)
        y = deform_conv2d(x.permute(0, 2, 3, 1), offsets, taps,
                          groups=self.groups, use_kernel=use_kernel)
        return y.permute(0, 3, 1, 2)


class DepthNet(nn.Module):
    """[N, Cin, H, W] + [N, cam] -> [N, D + C_ctx, H, W]."""

    def __init__(self, in_channels, mid, context_channels, depth_channels,
                 cam_channels=30):
        super().__init__()
        self.reduce_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1),
            GroupNorm(2, mid), nn.ReLU())
        self.context_conv = nn.Conv2d(mid, context_channels, 1)
        self.bn = GroupNorm(2, cam_channels)
        self.depth_mlp = Mlp(cam_channels, mid, mid)
        self.depth_se = SELayer(mid)
        self.context_mlp = Mlp(cam_channels, mid, mid)
        self.context_se = SELayer(mid)
        self.depth_conv = nn.Sequential(
            BasicBlock2d(mid), BasicBlock2d(mid), BasicBlock2d(mid),
            ASPP(mid, mid), DeformConvPack(mid),
            nn.Conv2d(mid, depth_channels, 1))

    def forward(self, x, mlp_input, generator=None, use_kernel=None):
        """``generator`` seeds the ASPP dropout in training mode;
        ``use_kernel`` goes to the DCN (P1)."""
        mlp_input = self.bn(mlp_input)
        x = self.reduce_conv(x)
        context = self.context_conv(
            self.context_se(x, self.context_mlp(mlp_input)))
        depth = self.depth_se(x, self.depth_mlp(mlp_input))
        for layer in self.depth_conv:
            if isinstance(layer, ASPP):
                depth = layer(depth, generator)
            elif isinstance(layer, DeformConvPack):
                depth = layer(depth, use_kernel)
            else:
                depth = layer(depth)
        return torch.cat([depth, context], dim=1)
