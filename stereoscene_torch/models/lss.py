"""LSS view transformer, port of ``stereoscene_tpu/models/lss.py``
(ref: ViewTransformerLSSVoxel.py:273-526): stereo volume + monocular depth
+ MIE fusion + lift-splat, over a static splat plan (kernel K3,
``ops.voxel_pool.lift_splat_static``) or, where the caller gives per-point
voxel ranks as training does, the dynamic ``ops.voxel_pool.lift_splat``
(lss.py:96-112). The splat runs in fp32 and its result is cast back to the
activation dtype.

Outputs the pooled voxel features [B, C_trans, X, Y, Z] and the fused depth
distribution [B, D, fH, fW].
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..ops.voxel_pool import lift_splat, lift_splat_static
from ..utils.spans import span
from .depth_net import DepthNet
from .layers import remat
from .mie import VolumeInteraction
from .stereo_volume import GwcVolumeEncoder


class ViewTransformerLiftSplatShootVoxel(nn.Module):
    def __init__(self, num_depth: int, numC_input: int = 640,
                 numC_Trans: int = 128, cam_channels: int = 30,
                 grid_shape: Tuple[int, int, int] = (128, 128, 16),
                 attention_chunk: int = 1024, splat_group: int = 1,
                 conv3d_kernel: bool = False, with_cp: bool = False):
        super().__init__()
        # with_cp: in training, checkpoint each hourglass and the MIE block
        # (lss.py:42-46 of the JAX package), so that the recompute of a
        # checkpointed view transformer holds one block at a time
        self.with_cp = with_cp
        self.num_depth = num_depth
        self.numC_Trans = numC_Trans
        self.grid_shape = tuple(grid_shape)
        self.splat_group = splat_group
        self.stereo_volume_net = GwcVolumeEncoder(
            num_depth, numC_input, cam_channels=cam_channels,
            conv3d_kernel=conv3d_kernel, with_cp=with_cp)
        self.depth_net = DepthNet(numC_input, numC_input, numC_Trans,
                                  num_depth, cam_channels)
        self.volume_interaction = VolumeInteraction(
            attention_chunk=attention_chunk, conv3d_kernel=conv3d_kernel)

    def forward(self, feat_left, feat_right, mlp_left, mlp_right, calib,
                plan, use_kernel=None, generator=None, aspp_mask=None):
        """feat_*: [B, C_in, fH, fW]; mlp_*: [B, cam]; calib: [B]; plan:
        (order, ranks_sorted, bounds) of a ``splat_plan`` plan built with
        ``group == splat_group``, or voxel ranks [B, D*fH*fW] for the
        dynamic splat; ``use_kernel`` goes to the K1, P1 and K3 wrappers,
        ``generator`` (or a mask drawn before, ``aspp_mask``) to the
        DepthNet's dropout."""
        self.depth_net.check_camera_width(mlp_left)
        with span("stereoscene.view.stereo"):
            stereo = self.stereo_volume_net(feat_left, feat_right, mlp_left,
                                            mlp_right, calib, use_kernel)
        with span("stereoscene.view.depth"):
            dn = self.depth_net(feat_left, mlp_left, generator, use_kernel,
                                aspp_mask)
            d = self.num_depth
            lss_prob = torch.softmax(dn[:, :d].float(),
                                     dim=1).to(feat_left.dtype)
            img_feat = dn[:, d:d + self.numC_Trans]
        with span("stereoscene.view.mie"):
            fused_prob = remat(self.with_cp, self.volume_interaction,
                               stereo["single_channel"], lss_prob)
        with span("stereoscene.view.splat"):
            feat = img_feat.permute(0, 2, 3, 1)
            if isinstance(plan, torch.Tensor):
                bev = lift_splat(fused_prob.float(), feat.float(), plan,
                                 self.grid_shape)
            else:  # K3 takes bf16 tables and widens them exactly
                order, ranks_sorted, bounds = plan
                bev = lift_splat_static(
                    fused_prob, feat, order, ranks_sorted,
                    self.grid_shape, group=self.splat_group, bounds=bounds,
                    use_kernel=use_kernel)
            # [B, X, Y, Z, C] -> [B, C, X, Y, Z] (a channels-last-3d view)
            bev = bev.to(feat_left.dtype).permute(0, 4, 1, 2, 3)
        return bev, fused_prob
