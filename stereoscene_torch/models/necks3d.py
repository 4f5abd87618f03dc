"""Alternate 3D necks, port of ``stereoscene_tpu/models/necks3d.py``:

- ``FPN3D`` (ref: occupancy/necks/fpn3d.py:13-126): 1x1x1 laterals to a
  common width, top-down additive fusion (the coarser level trilinearly
  upsampled onto the finer one), a 3x3x3 conv per level, and
  ``num_upsample`` extra stride-2 deconv levels before the finest.
- ``SpconvNeck3D`` (ref: occupancy/necks/spconv_neck.py:13-107): the same
  laterals and convs fused fine to coarse (the finer map resized down onto
  each level, with ``jax.image.resize``'s antialiased weights,
  ``ops.resize``); dense convs stand in for spconv, as in the JAX package.

Both take a list of channels-first grids [B, C_i, X_i, Y_i, Z_i] and
return a list of [B, C_out, X_i, Y_i, Z_i]. Keys follow the JAX module
names (``lateral0.conv.weight``, ``fpn1.gn.bias``, ``upsample0_deconv``).
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_trilinear
from .layers import Conv3d, GroupNorm


def _resize(x, like):
    """Channels-first [B, C, X, Y, Z] resized onto ``like``'s grid."""
    out = resize_trilinear(x.permute(0, 2, 3, 4, 1), like.shape[2:])
    return out.permute(0, 4, 1, 2, 3)


class ConvGNReLU3d(nn.Module):
    """mmcv ConvModule(conv3d without bias, GN, ReLU)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 padding: int = 1, norm_groups: int = 32):
        super().__init__()
        self.conv = Conv3d(cin, features, kernel, padding=padding, bias=False)
        self.gn = GroupNorm(norm_groups, features)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class FPN3D(nn.Module):
    """Top-down 3D feature pyramid (ref: fpn3d.py:13-126)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_upsample: int = 0, norm_groups: int = 32):
        super().__init__()
        self.n = len(in_channels)
        self.num_upsample = num_upsample
        for i, cin in enumerate(in_channels):
            setattr(self, f"lateral{i}", ConvGNReLU3d(
                cin, out_channels, 1, 0, norm_groups))
            setattr(self, f"fpn{i}", ConvGNReLU3d(
                out_channels, out_channels, norm_groups=norm_groups))
        for i in range(num_upsample):
            setattr(self, f"upsample{i}_deconv", nn.ConvTranspose3d(
                out_channels, out_channels, 2, stride=2, bias=False))
            setattr(self, f"upsample{i}_gn",
                    GroupNorm(norm_groups, out_channels))

    def forward(self, feats):
        assert len(feats) == self.n
        lat = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.n - 1, 0, -1):  # coarse -> fine (ref :103-107)
            lat[i - 1] = lat[i - 1] + _resize(lat[i], lat[i - 1])
        outs = [getattr(self, f"fpn{i}")(lat[i]) for i in range(self.n)]
        up = outs[0]
        for i in range(self.num_upsample):  # extra levels (ref :117-123)
            up = getattr(self, f"upsample{i}_deconv")(up)
            up = F.relu(getattr(self, f"upsample{i}_gn")(up))
            outs.insert(0, up)
        return outs


class SpconvNeck3D(nn.Module):
    """Fine-to-coarse fused 3D pyramid (ref: spconv_neck.py:13-107)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 norm_groups: int = 32):
        super().__init__()
        self.n = len(in_channels)
        for i, cin in enumerate(in_channels):
            setattr(self, f"lateral{i}", ConvGNReLU3d(
                cin, out_channels, 1, 0, norm_groups))
            setattr(self, f"fpn{i}", ConvGNReLU3d(
                out_channels, out_channels, norm_groups=norm_groups))

    def forward(self, feats):
        assert len(feats) == self.n
        lat = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(1, self.n):  # fine -> coarse (ref :98-101)
            lat[i] = lat[i] + _resize(lat[i - 1], lat[i])
        return [getattr(self, f"fpn{i}")(lat[i]) for i in range(self.n)]
