"""3D voxel encoder, port of ``stereoscene_tpu/models/resnet3d.py``
(ref: occupancy/backbones/resnet3d.py:35-245): a 1x1x1 input projection,
then residual stages with GroupNorm: BasicBlocks at depths 10, 18 and 34,
Bottlenecks (4x wide) at 50 and 101. Each stage's first block takes the
stage's stride; ``out_indices`` picks the stages returned. With ``crp3d``
(off in the scored config) the CRP3D context-relation prior
(``models/crp3d.py``) hooks in after stage ``crp_level``, as the JAX
package's (resnet3d.py:83-119), and the forward also returns its relation
logits.

Its convs and norms are the voxel grid's (``sharded=True``): on an X slab
of a sharded grid (``parallel.spatial``) they exchange halos and pool
their statistics over the space group. CRP3D reads the whole grid: there
every space rank gathers the stage's slabs, runs it whole and keeps its
own slab of the features; the relation logits are whole on every rank.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from .layers import Conv3d, GroupNorm

# blocks a stage by depth (the reference's BasicBlock depths 10/18/34 and
# Bottleneck depths 50/101)
STAGE_BLOCKS = {10: (1, 1, 1, 1), 18: (2, 2, 2, 2), 34: (3, 4, 6, 3),
                50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class BasicBlock3d(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, gn_groups=32,
                 conv3d_kernel=False):
        super().__init__()
        k = dict(bias=False, kernel=conv3d_kernel, sharded=True)
        self.conv1 = Conv3d(cin, planes, 3, stride=stride, padding=1, **k)
        self.bn1 = GroupNorm(gn_groups, planes, sharded=True)
        self.conv2 = Conv3d(planes, planes, 3, padding=1, **k)
        self.bn2 = GroupNorm(gn_groups, planes, sharded=True)
        self.downsample = _downsample(cin, planes, stride, gn_groups, k)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck3d(nn.Module):
    """1x1x1 -> 3x3x3 at the stride -> 1x1x1 to 4x ``planes``, GroupNorm
    after each (resnet3d.py:48-71 of the JAX package)."""

    expansion = 4

    def __init__(self, cin, planes, stride=1, gn_groups=32,
                 conv3d_kernel=False):
        super().__init__()
        k = dict(bias=False, kernel=conv3d_kernel, sharded=True)
        out = planes * self.expansion
        self.conv1 = Conv3d(cin, planes, 1, **k)
        self.bn1 = GroupNorm(gn_groups, planes, sharded=True)
        self.conv2 = Conv3d(planes, planes, 3, stride=stride, padding=1, **k)
        self.bn2 = GroupNorm(gn_groups, planes, sharded=True)
        self.conv3 = Conv3d(planes, out, 1, **k)
        self.bn3 = GroupNorm(gn_groups, out, sharded=True)
        self.downsample = _downsample(cin, out, stride, gn_groups, k)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def _downsample(cin, cout, stride, gn_groups, k):
    """The 1x1x1 projection of the residual where the stride or the width
    changes, else None."""
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(Conv3d(cin, cout, 1, stride=stride, **k),
                         GroupNorm(gn_groups, cout, sharded=True))


def block_class(depth: int):
    if depth not in STAGE_BLOCKS:
        raise ValueError(f"CustomResNet3D depth {depth} is not one of "
                         f"{sorted(STAGE_BLOCKS)}")
    return BasicBlock3d if depth in (10, 18, 34) else Bottleneck3d


def stage_widths(depth: int, block_inplanes: Sequence[int]) -> Tuple[int, ...]:
    """The output width of each stage: ``block_inplanes`` times the block's
    expansion (4 for the Bottleneck depths)."""
    e = block_class(depth).expansion
    return tuple(e * c for c in block_inplanes)


class CustomResNet3D(nn.Module):
    def __init__(self, in_channels: int, block_inplanes: Sequence[int],
                 block_strides: Sequence[int], depth: int = 18,
                 norm_groups: int = 32, conv3d_kernel: bool = False,
                 crp3d: bool = False, crp_level: int = 2,
                 crp_mega_shape: Tuple[int, int, int] = (32, 32, 4),
                 out_indices: Sequence[int] = (0, 1, 2)):
        super().__init__()
        self.crp_level = crp_level if crp3d else None
        self.out_indices = tuple(out_indices)
        block = block_class(depth)
        counts = STAGE_BLOCKS[depth]
        self.input_proj = nn.Sequential(
            nn.Conv3d(in_channels, block_inplanes[0], 1, bias=False),
            GroupNorm(norm_groups, block_inplanes[0], sharded=True),
            nn.ReLU())
        layers = []
        cin = block_inplanes[0]
        for s, (planes, stride) in enumerate(zip(block_inplanes,
                                                 block_strides)):
            stage = []
            for i in range(counts[s]):
                stage.append(block(cin, planes, stride if i == 0 else 1,
                                   norm_groups, conv3d_kernel))
                cin = planes * block.expansion
            layers.append(nn.Sequential(*stage))
        self.layers = nn.ModuleList(layers)
        if crp3d:
            from .crp3d import CPMegaVoxels

            self.cp_mega_voxels = CPMegaVoxels(
                block_inplanes[crp_level], crp_mega_shape,
                norm_groups=norm_groups,
                in_channels=stage_widths(depth, block_inplanes)[crp_level])

    def _crp(self, x):
        """CRP3D over the whole grid; on a sharded grid the slabs are
        gathered, every space rank runs it whole and keeps its slab."""
        if not spatial.active():
            return self.cp_mega_voxels(x)
        out, crp_logits = self.cp_mega_voxels(spatial.gather_slabs(x))
        return spatial.shard_voxels(out), crp_logits

    def forward(self, x):
        """-> the outputs of the stages in ``out_indices``, with ``crp3d``
        (outputs, relation logits)."""
        x = self.input_proj(x)
        outs = []
        crp_logits = None
        for stage, layer in enumerate(self.layers):
            x = layer(x)
            if stage == self.crp_level:
                x, crp_logits = self._crp(x)
            if stage in self.out_indices:
                outs.append(x)
        if self.crp_level is not None:
            return outs, crp_logits
        return outs
