"""SharedOccHead: one MLP decodes both voxels and query points, port of
``stereoscene_tpu/models/shared_occhead.py`` (ref: occupancy/dense_heads/
shared_occhead.py:22-252).

The finest voxel grid [B, X, Y, Z, C] (channels-last, as in the JAX
package) goes through the shared MLP (Linear -> Softplus -> Linear ->
Linear, ref :58-64) cell by cell; query points sample the same grid with
the OccHead's trilinear sampler and go through the same MLP, so a cell's
centre decoded as a point gives its voxel logits. With
``sampling_img_feats`` the image features sampled at the points'
projections are reduced by ``img_feat_reduce`` and added (ref :115-131).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .occhead import bilinear_image_sample, trilinear_point_sample


class SharedMlp(nn.Module):
    def __init__(self, in_channels: int, hidden: int, out_channel: int):
        super().__init__()
        self.fc0 = nn.Linear(in_channels, hidden)
        self.fc1 = nn.Linear(hidden, hidden)
        self.fc2 = nn.Linear(hidden, out_channel)

    def forward(self, x):
        return self.fc2(self.fc1(F.softplus(self.fc0(x))))


class SharedOccHead(nn.Module):
    def __init__(self, in_channels: int, out_channel: int,
                 hidden_dims: int = 128, sampling_img_feats: bool = False,
                 in_img_channels: int = 640,
                 point_cloud_range: Sequence[float] = (0.0, -25.6, -2.0,
                                                       51.2, 25.6, 4.4)):
        super().__init__()
        self.sampling_img_feats = sampling_img_feats
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.shared_mlp = SharedMlp(in_channels, hidden_dims, out_channel)
        if sampling_img_feats:
            self.img_feat_reduce = nn.Linear(in_img_channels, in_channels)

    def forward(self, voxel_feats: List[torch.Tensor],
                points: Optional[torch.Tensor] = None,
                img_feats: Optional[torch.Tensor] = None,
                points_uv: Optional[torch.Tensor] = None):
        """voxel_feats: grids [B, X, Y, Z, C] (the last is decoded);
        points [B, P, >=3] ego xyz; img_feats [B, H, W, C_img] and
        points_uv [B, P, 2] in [-1, 1] for the image branch. Returns
        ``output_voxels`` ([B, X, Y, Z, classes]) and ``output_points``
        ([B, P, classes] or None)."""
        grid = voxel_feats[-1]
        output_points = None
        if points is not None:
            dev = points.device
            lo = torch.tensor(self.point_cloud_range[:3], device=dev)
            hi = torch.tensor(self.point_cloud_range[3:], device=dev)
            norm = (points[..., :3].float() - lo) / (hi - lo) * 2.0 - 1.0
            feats = trilinear_point_sample(grid, norm)
            if self.sampling_img_feats and img_feats is not None:
                # sample first, then reduce: the two commute
                feats = feats + self.img_feat_reduce(
                    bilinear_image_sample(img_feats, points_uv))
            output_points = self.shared_mlp(feats)
        return {"output_voxels": [self.shared_mlp(grid)],
                "output_points": output_points}
