"""CRP3D: the context-relation prior over mega-voxels, port of
``stereoscene_tpu/models/crp3d.py`` (ref: occupancy/backbones/crp3d.py:
173-262, hooked into CustomResNet3D at resnet3d.py:158-165 and supervised
by ``compute_super_CP_multilabel_loss`` resnet3d.py:269-290; off in the
scored config).

Pool the stage features onto a coarse mega-voxel grid, predict for every
(voxel, mega-voxel) pair ``n_relations`` logits, use their mean sigmoid to
gather mega-voxel context back into each voxel, and return the enriched
features with the relation logits for ``crp_relation_loss``. Channels
first: x [B, C, X, Y, Z]; voxels and mega-voxels are flattened in (X, Y,
Z) order, the order of ``data.labels.compute_cp_mega_matrix``'s rows and
columns when the mega grid is half the stage grid.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import all_sum
from .layers import GroupNorm


class CPMegaVoxels(nn.Module):
    def __init__(self, channels: int,
                 mega_shape: Tuple[int, int, int] = (32, 32, 4),
                 n_relations: int = 4, norm_groups: int = 4):
        super().__init__()
        self.channels = channels
        self.mega_shape = tuple(mega_shape)
        self.mega_context = nn.Conv3d(channels, channels, 1)
        self.voxel_reduce = nn.Conv3d(channels, channels, 1)
        self.voxel_gn = GroupNorm(norm_groups, channels)
        self.mega_key = nn.Linear(channels, channels)
        self.relation_head = nn.Linear(channels, n_relations)
        self.fuse = nn.Conv3d(2 * channels, channels, 1)

    def forward(self, x: torch.Tensor):
        """x [B, C, X, Y, Z] -> (features [B, C, X, Y, Z], relation logits
        [B, n_relations, X*Y*Z, n_mega] fp32)."""
        b, c, xs, ys, zs = x.shape
        mx, my, mz = self.mega_shape
        mega = x.reshape(b, c, mx, xs // mx, my, ys // my, mz,
                         zs // mz).mean(dim=(3, 5, 7))
        mega_flat = self.mega_context(mega).flatten(2).transpose(1, 2)
        rel = F.relu(self.voxel_gn(self.voxel_reduce(x)))
        rel_flat = rel.flatten(2).transpose(1, 2)             # [B, V, C]
        mega_key = self.mega_key(mega_flat)                   # [B, M, C]
        # fp32 products of the (possibly bf16) operands, as JAX's
        # preferred_element_type=float32
        logits = torch.einsum("bvc,bmc->bvm", rel_flat.float(),
                              mega_key.float())
        rel_scale = self.relation_head(rel_flat)              # [B, V, R]
        p_logits = logits[:, None] * rel_scale.transpose(1, 2)[..., None]
        weights = torch.sigmoid(p_logits.float()).mean(dim=1)
        context = torch.einsum("bvm,bmc->bvc",
                               weights.to(x.dtype).float(),
                               mega_flat.float()).to(x.dtype)
        context = context.transpose(1, 2).reshape(b, self.channels, xs, ys,
                                                  zs)
        return self.fuse(torch.cat([x, context], dim=1)), p_logits


def crp_relation_loss(p_logits: torch.Tensor,
                      cp_mega_matrix: torch.Tensor) -> torch.Tensor:
    """Multi-label BCE with per-relation pos_weight = #neg / #pos
    (ref: resnet3d.py:269-290), the mean over every (sample, relation,
    voxel, mega-voxel). Over ranks the counts and the sum pool, and the
    mean divides by the global count.

    Args:
      p_logits: [B, R, V, M].
      cp_mega_matrix: [B, R, V, M] binary targets.
    """
    logits = p_logits.float().reshape(p_logits.shape[0], p_logits.shape[1],
                                      -1)
    labels = cp_mega_matrix.float().reshape(logits.shape)
    r = logits.shape[1]
    counts = all_sum(torch.cat([labels.sum(dim=(0, 2)),
                                (1.0 - labels).sum(dim=(0, 2)),
                                logits.new_full((1,), logits.numel())]))
    cnt_pos, cnt_neg, total = counts[:r], counts[r:2 * r], counts[-1]
    pos_weight = cnt_neg / cnt_pos.clamp_min(1.0)
    per = -(pos_weight[None, :, None] * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    return all_sum(per.sum()) / total
