"""SECOND-style FPN necks, port of ``stereoscene_tpu/models/second_fpn.py``.

- ``SECONDFPN`` (image neck, mmdet3d): per level a strided conv (fractional
  stride) or a transposed conv (integer stride), BN(eps 1e-3) + ReLU, then
  channel concat. Keys ``deblocks.i.{0,1}``.
- ``SECONDFPN3D`` (voxel neck, ref second_fpn_3d.py:13-117): per level a
  k = s transposed conv3d + GroupNorm + ReLU, then concat. On an X slab of
  a sharded grid (``parallel.spatial``) the transposed convs are
  slab-local (each output plane reads one input plane) and the norms pool
  over the space group.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import BatchNorm, ConvTransposeTorch, GroupNorm


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 upsample_strides: Sequence[float]):
        super().__init__()
        deblocks = []
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            if s >= 1:
                up = ConvTransposeTorch(cin, cout, int(s), ndim=2,
                                        stride=int(s))
            else:
                k = int(round(1 / s))
                up = nn.Conv2d(cin, cout, k, stride=k, bias=False)
            deblocks.append(nn.Sequential(
                up, BatchNorm(cout, eps=1e-3, momentum=0.01), nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, feats):
        return torch.cat([d(f) for d, f in zip(self.deblocks, feats)], dim=1)


class SECONDFPN3D(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 upsample_strides: Sequence[int], norm_groups: int = 32):
        super().__init__()
        self.deblocks = nn.ModuleList(
            nn.Sequential(
                ConvTransposeTorch(cin, cout, int(s), ndim=3, stride=int(s)),
                GroupNorm(norm_groups, cout, sharded=True), nn.ReLU())
            for cin, cout, s in zip(in_channels, out_channels,
                                    upsample_strides))

    def forward(self, feats):
        if len(feats) != len(self.deblocks):
            raise ValueError(f"SECONDFPN3D takes {len(self.deblocks)} "
                             f"levels, got {len(feats)}")
        return torch.cat([d(f) for d, f in zip(self.deblocks, feats)], dim=1)
