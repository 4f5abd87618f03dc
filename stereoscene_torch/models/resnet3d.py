"""3D voxel encoder, port of ``stereoscene_tpu/models/resnet3d.py``
(ref: occupancy/backbones/resnet3d.py:35-245): a 1x1x1 input projection,
then residual BasicBlock stages (depth 10 or 18) with GroupNorm. With
``crp3d`` (off in the scored config) the CRP3D context-relation prior
(``models/crp3d.py``) hooks in after stage ``crp_level``, as the JAX
package's (resnet3d.py:83-119), and the forward also returns its relation
logits.

Its convs and norms are the voxel grid's (``sharded=True``): on an X slab
of a sharded grid (``parallel.spatial``) they exchange halos and pool
their statistics over the space group.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv3d, GroupNorm

# blocks a stage by depth (the reference's BasicBlock depths 10 and 18)
STAGE_BLOCKS = {10: 1, 18: 2}


class BasicBlock3d(nn.Module):
    def __init__(self, cin, planes, stride=1, gn_groups=32,
                 conv3d_kernel=False):
        super().__init__()
        k = dict(bias=False, kernel=conv3d_kernel, sharded=True)
        self.conv1 = Conv3d(cin, planes, 3, stride=stride, padding=1, **k)
        self.bn1 = GroupNorm(gn_groups, planes, sharded=True)
        self.conv2 = Conv3d(planes, planes, 3, padding=1, **k)
        self.bn2 = GroupNorm(gn_groups, planes, sharded=True)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                Conv3d(cin, planes, 1, stride=stride, **k),
                GroupNorm(gn_groups, planes, sharded=True))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class CustomResNet3D(nn.Module):
    def __init__(self, in_channels: int, block_inplanes: Sequence[int],
                 block_strides: Sequence[int], depth: int = 18,
                 norm_groups: int = 32, conv3d_kernel: bool = False,
                 crp3d: bool = False, crp_level: int = 2,
                 crp_mega_shape: Tuple[int, int, int] = (32, 32, 4)):
        super().__init__()
        self.crp_level = crp_level if crp3d else None
        if depth not in STAGE_BLOCKS:
            raise ValueError(f"CustomResNet3D depth {depth} is not built "
                             f"(depths {sorted(STAGE_BLOCKS)})")
        blocks = STAGE_BLOCKS[depth]
        self.input_proj = nn.Sequential(
            nn.Conv3d(in_channels, block_inplanes[0], 1, bias=False),
            GroupNorm(norm_groups, block_inplanes[0], sharded=True),
            nn.ReLU())
        layers = []
        cin = block_inplanes[0]
        for planes, stride in zip(block_inplanes, block_strides):
            stage = [BasicBlock3d(cin, planes, stride, norm_groups,
                                  conv3d_kernel)]
            stage += [BasicBlock3d(planes, planes, 1, norm_groups,
                                   conv3d_kernel) for _ in range(1, blocks)]
            layers.append(nn.Sequential(*stage))
            cin = planes
        self.layers = nn.ModuleList(layers)
        if crp3d:
            from .crp3d import CPMegaVoxels

            self.cp_mega_voxels = CPMegaVoxels(
                block_inplanes[crp_level], crp_mega_shape,
                norm_groups=norm_groups)

    def forward(self, x):
        """-> the stages' outputs, with ``crp3d`` (outputs, relation
        logits)."""
        x = self.input_proj(x)
        outs = []
        crp_logits = None
        for stage, layer in enumerate(self.layers):
            x = layer(x)
            if stage == self.crp_level:
                x, crp_logits = self.cp_mega_voxels(x)
            outs.append(x)
        if self.crp_level is not None:
            return outs, crp_logits
        return outs
