"""Voxel middle encoders, port of ``stereoscene_tpu/models/voxel_encoder.py``
(ref: occupancy/voxel_encoder/sparse_encoder.py, sparse_unet.py): dense
stand-ins for the spconv alternates over scatter-voxelised inputs.

``voxelize_points`` mean-pools point features into a dense grid with the
plain scatter ``ops.voxel_pool.voxel_pool_scatter`` (an ``index_add`` with
an overflow row for out-of-range points, dropped; the JAX package's
``voxel_pool_scatter``, mode "drop"). ``DenseSparseEncoder`` is a
SECOND-style middle encoder, ``DenseUNet3D`` a symmetric UNet with skip
concats. Grids are channels-first [B, C, X, Y, Z]; keys follow the JAX
module names.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.voxel_pool import voxel_pool_scatter
from .layers import Conv3d, GroupNorm


def voxelize_points(points: torch.Tensor, features: torch.Tensor,
                    valid: torch.Tensor, grid_shape: Tuple[int, int, int],
                    pc_range: Sequence[float]) -> torch.Tensor:
    """Mean of the features [P, C] of the valid points [P, 3] (ego xyz)
    in each voxel -> [X, Y, Z, C] (the Voxelization + HardSimpleVFE
    equivalent, ref ViewTransformerSpconv.py:16)."""
    nx, ny, nz = grid_shape
    dev = points.device
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    hi = torch.tensor(pc_range[3:], dtype=torch.float32, device=dev)
    shape = torch.tensor(grid_shape, device=dev)
    size = (hi - lo) / shape.float()
    coords = torch.floor((points.float() - lo) / size).long()
    ok = valid & ((coords >= 0) & (coords < shape)).all(dim=-1)
    n = nx * ny * nz
    ranks = torch.where(
        ok, coords[:, 0] * (ny * nz) + coords[:, 1] * nz + coords[:, 2], n)
    summed = voxel_pool_scatter(features, ranks, n)
    counts = voxel_pool_scatter(features.new_ones(features.shape[0], 1),
                                ranks, n)
    return (summed / torch.clamp(counts, min=1.0)).reshape(nx, ny, nz, -1)


class ConvGNBlock(nn.Module):
    """conv3d (3x3x3, no bias) -> GroupNorm -> ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 norm_groups: int = 16):
        super().__init__()
        self.conv = Conv3d(cin, features, 3, stride=stride, padding=1,
                           bias=False)
        self.gn = GroupNorm(norm_groups, features)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class DenseSparseEncoder(nn.Module):
    """SECOND-style middle encoder (CustomSparseEncoder equivalent)."""

    def __init__(self, in_channels: int, base_channels: int = 16,
                 encoder_channels: Sequence[int] = (16, 32, 64, 128),
                 out_channels: int = 128, norm_groups: int = 8):
        super().__init__()
        self.n = len(encoder_channels)
        self.stem = ConvGNBlock(in_channels, base_channels,
                                norm_groups=norm_groups)
        cin = base_channels
        for i, ch in enumerate(encoder_channels):
            setattr(self, f"down{i}", ConvGNBlock(
                cin, ch, stride=1 if i == 0 else 2, norm_groups=norm_groups))
            setattr(self, f"res{i}", ConvGNBlock(ch, ch,
                                                 norm_groups=norm_groups))
            cin = ch
        self.out = ConvGNBlock(cin, out_channels, norm_groups=norm_groups)

    def forward(self, x):
        x = self.stem(x)
        for i in range(self.n):
            x = getattr(self, f"res{i}")(getattr(self, f"down{i}")(x))
        return self.out(x)


class DenseUNet3D(nn.Module):
    """Symmetric 3D UNet (CustomSparseUNet equivalent)."""

    def __init__(self, in_channels: int,
                 channels: Sequence[int] = (16, 32, 64),
                 norm_groups: int = 8):
        super().__init__()
        self.n = len(channels)
        cin = in_channels
        for i, ch in enumerate(channels):
            setattr(self, f"enc{i}", ConvGNBlock(
                cin, ch, stride=1 if i == 0 else 2, norm_groups=norm_groups))
            cin = ch
        for i in range(self.n - 1):
            setattr(self, f"up{i}", nn.ConvTranspose3d(
                channels[i + 1], channels[i], 2, stride=2, bias=False))
            setattr(self, f"dec{i}", ConvGNBlock(
                2 * channels[i], channels[i], norm_groups=norm_groups))

    def forward(self, x):
        skips = []
        for i in range(self.n):
            x = getattr(self, f"enc{i}")(x)
            skips.append(x)
        for i in reversed(range(self.n - 1)):
            x = torch.cat([getattr(self, f"up{i}")(x), skips[i]], dim=1)
            x = getattr(self, f"dec{i}")(x)
        return x
