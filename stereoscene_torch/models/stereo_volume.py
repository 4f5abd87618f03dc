"""Stereo plane-sweep branch, port of
``stereoscene_tpu/models/stereo_volume.py``
(ref: ViewTransformerLSSVoxel.py:32-224).

- ``StereoFeatureNet``: 3x3 reduce conv + GN(2) + ReLU, camera-aware SE,
  1x1 to the matching features.
- ``Hourglass3D``: two stride-2 ConvGN3d encoders, two k3 s2 transposed-conv
  decoders with BatchNorm3d, 1x1 ConvGN3d redirect skips.
- ``GwcVolumeEncoder``: group-wise correlation + depth warp (kernel K1,
  ``ops.gwc.fused_gwc_warp``), the dres0/dres1 stem, three hourglasses and
  the two heads, with the fp32 depth softmax.

Features enter [B, C, fH, fW]; volumes are [B, C, D, fH, fW]. Built with
``conv3d_kernel=True``, the hourglasses' 64 -> 64 and 128 -> 128 convs run
kernel K4 (``layers.Conv3d``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry import disparity_positions
from ..ops.gwc import fused_gwc_warp
from .layers import BatchNorm, ConvGN3d, ConvTransposeTorch, GroupNorm, Mlp, \
    SELayer, remat


class StereoFeatureNet(nn.Module):
    def __init__(self, in_channels, mid_channels=128, depth_channels=64,
                 cam_channels=30):
        super().__init__()
        self.reduce_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid_channels, 3, padding=1),
            GroupNorm(2, mid_channels), nn.ReLU())
        self.depth_mlp = Mlp(cam_channels, mid_channels, mid_channels)
        self.depth_se = SELayer(mid_channels)
        self.depth_conv = nn.Sequential(
            nn.Conv2d(mid_channels, depth_channels, 1))

    def forward(self, x, mlp_input):
        y = self.reduce_conv(x)
        y = self.depth_se(y, self.depth_mlp(mlp_input))
        return self.depth_conv(y)


class Hourglass3D(nn.Module):
    def __init__(self, c: int, conv3d_kernel: bool = False):
        super().__init__()
        k = dict(conv3d_kernel=conv3d_kernel)
        self.conv1 = nn.Sequential(ConvGN3d(c, 2 * c, 3, 2, 1, **k), nn.ReLU())
        self.conv2 = nn.Sequential(ConvGN3d(2 * c, 2 * c, 3, 1, 1, **k),
                                   nn.ReLU())
        self.conv3 = nn.Sequential(ConvGN3d(2 * c, 4 * c, 3, 2, 1, **k),
                                   nn.ReLU())
        self.conv4 = nn.Sequential(ConvGN3d(4 * c, 4 * c, 3, 1, 1, **k),
                                   nn.ReLU())
        self.conv5 = nn.Sequential(
            ConvTransposeTorch(4 * c, 2 * c, 3, ndim=3, stride=2, padding=1,
                               output_padding=1),
            BatchNorm(2 * c))
        self.conv6 = nn.Sequential(
            ConvTransposeTorch(2 * c, c, 3, ndim=3, stride=2, padding=1,
                               output_padding=1),
            BatchNorm(c))
        self.redir1 = ConvGN3d(c, c, 1, 1, 0, **k)
        self.redir2 = ConvGN3d(2 * c, 2 * c, 1, 1, 0, **k)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c4 = self.conv4(self.conv3(c2))
        c5 = F.relu(self.conv5(c4) + self.redir2(c2))
        return F.relu(self.conv6(c5) + self.redir1(x))


class GwcVolumeEncoder(nn.Module):
    def __init__(self, max_disp, in_channels, out_channels=32, num_groups=32,
                 mid_channels=128, match_channels=64, cam_channels=30,
                 conv3d_kernel=False, with_cp=False):
        super().__init__()
        self.max_disp = max_disp
        self.with_cp = with_cp  # checkpoint each hourglass in training
        self.num_groups = num_groups
        self.feature_withcam = StereoFeatureNet(
            in_channels, mid_channels, match_channels, cam_channels)
        g = num_groups
        self.dres0 = nn.Sequential(ConvGN3d(g, 32), nn.ReLU(),
                                   ConvGN3d(32, 32), nn.ReLU())
        self.dres1 = nn.Sequential(ConvGN3d(32, 32), nn.ReLU(),
                                   ConvGN3d(32, 32))
        self.dres2 = Hourglass3D(32, conv3d_kernel)
        self.dres3 = Hourglass3D(32, conv3d_kernel)
        self.dres4 = Hourglass3D(32, conv3d_kernel)
        self.classif3_1 = nn.Sequential(ConvGN3d(32, out_channels), nn.ReLU())
        self.classif3_2 = nn.Sequential(
            nn.Conv3d(out_channels, 1, 3, padding=1, bias=False))

    def forward(self, left, right, mlp_left, mlp_right, calib,
                use_kernel=None) -> Dict[str, torch.Tensor]:
        b = left.shape[0]
        match = self.feature_withcam(torch.cat([left, right], 0),
                                     torch.cat([mlp_left, mlp_right], 0))
        match = match.permute(0, 2, 3, 1)  # [2B, fH, fW, C] for the kernel
        pos = disparity_positions(calib, self.max_disp)
        vol = fused_gwc_warp(match[:b], match[b:], pos, self.max_disp,
                             self.num_groups, out_dtype=left.dtype,
                             use_kernel=use_kernel)
        vol = vol.permute(0, 4, 1, 2, 3)  # [B, G, D, fH, fW] (a view)
        cost0 = self.dres0(vol)
        cost0 = self.dres1(cost0) + cost0
        out3 = cost0
        for hourglass in (self.dres2, self.dres3, self.dres4):
            out3 = remat(self.with_cp, hourglass, out3)
        multi = self.classif3_1(out3)
        single = self.classif3_2(multi)[:, 0]
        prob = torch.softmax(single.float(), dim=1).to(left.dtype)
        return {"multi_channel": multi, "single_channel": prob}
