"""Occupancy head, port of ``stereoscene_tpu/models/occhead.py``
(ref: occupancy/dense_heads/occhead.py:28-426).

Voxel branch (ref :96-108): Conv3d(in -> in/2, 3x3x3) -> GN -> ReLU ->
Conv3d(in/2 -> classes, 1x1x1).

Point branch (``supervise_points``, off in the scored config
stereoscene.py:111; ref :171-218): the voxel features sampled
trilinearly at the query points, optionally image features sampled
bilinearly at their projections (``sampling_img_feats``, through
``img_feat_reduce``), the levels fused by learned soft weights
(``soft_weights``) or summed, then ``point_occ_mlp``. The detector turns
the branch on without the two options, as the JAX package's does. The two
samplers are the JAX package's formulas, not ``F.grid_sample``: the
trilinear one puts a point's x on the volume's first axis, and the
bilinear one clips the top-left corner to [0, W-2] x [0, H-2].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import GroupNorm, Mlp


def trilinear_point_sample(vol: torch.Tensor,
                           pts: torch.Tensor) -> torch.Tensor:
    """Sample vol [B, X, Y, Z, C] at normalized points pts [B, P, 3] in
    [-1, 1]^3 (pts[..., 0] on X, 1 on Y, 2 on Z), half-pixel centres
    (align_corners=False), zero outside -> [B, P, C] in vol's dtype."""
    b, xs, ys, zs, c = vol.shape
    dims = torch.tensor([xs, ys, zs], dtype=torch.float32, device=vol.device)
    idx = ((pts.float() + 1.0) * dims - 1.0) / 2.0
    i0 = torch.floor(idx).long()
    frac = idx - i0.float()
    flat = vol.reshape(b, -1, c)
    hi = dims.long() - 1
    out = torch.zeros((b, pts.shape[1], c), dtype=vol.dtype,
                      device=vol.device)
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                off = torch.tensor([cx, cy, cz], device=vol.device)
                ii = i0 + off
                inside = ((ii >= 0) & (ii <= hi)).all(dim=-1)
                ii = torch.minimum(ii.clamp_min(0), hi)
                lin = (ii[..., 0] * ys + ii[..., 1]) * zs + ii[..., 2]
                vals = flat.gather(1, lin[..., None].expand(-1, -1, c))
                w = torch.where(off.bool(), frac, 1.0 - frac).prod(dim=-1)
                out = out + (vals * (w * inside.float())[..., None]).to(
                    vol.dtype)
    return out


def bilinear_image_sample(feat: torch.Tensor,
                          uv: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample feat [B, H, W, C] at normalized uv [B, P, 2] in
    [-1, 1] (x over W, y over H), the top-left corner clipped to
    [0, W-2] x [0, H-2] -> [B, P, C], fp32 weights."""
    b, h, w, c = feat.shape
    xy = (uv.float() + 1.0) / 2.0
    px = xy[..., 0] * (w - 1)
    py = xy[..., 1] * (h - 1)
    x0 = torch.floor(px).long().clamp(0, w - 2)
    y0 = torch.floor(py).long().clamp(0, h - 2)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]
    flat = feat.reshape(b, h * w, c)

    def at(yy, xx):
        return flat.gather(1, (yy * w + xx)[..., None].expand(-1, -1, c))

    return (at(y0, x0) * ((1 - fx) * (1 - fy))
            + at(y0, x0 + 1) * (fx * (1 - fy))
            + at(y0 + 1, x0) * ((1 - fx) * fy)
            + at(y0 + 1, x0 + 1) * (fx * fy))


class OccHead(nn.Module):
    def __init__(self, in_channels: int, out_channel: int,
                 norm_groups: int = 32, supervise_points: bool = False,
                 sampling_img_feats: bool = False,
                 soft_weights: bool = False, in_img_channels: int = 640):
        super().__init__()
        mid = in_channels // 2
        self.occ_convs = nn.ModuleList([nn.Sequential(
            nn.Conv3d(in_channels, mid, 3, padding=1, bias=False),
            GroupNorm(norm_groups, mid), nn.ReLU(),
            nn.Conv3d(mid, out_channel, 1, bias=False))])
        self.supervise_points = supervise_points
        self.sampling_img_feats = sampling_img_feats
        self.soft_weights = soft_weights
        if supervise_points:
            if sampling_img_feats:
                self.img_feat_reduce = nn.Linear(in_img_channels,
                                                 in_channels)
            if soft_weights:
                n_feats = 1 + int(sampling_img_feats)
                self.soft_w1 = nn.Linear(in_channels, in_channels // 2)
                self.soft_w2 = nn.Linear(in_channels // 2, n_feats)
            self.point_occ_mlp = Mlp(in_channels, in_channels, out_channel)

    def forward(self, x):
        """[B, C, X, Y, Z] -> logits [B, classes, X, Y, Z]."""
        return self.occ_convs[0](x)

    def forward_points(self, x, points, img_feats=None, points_uv=None):
        """The point branch: voxel features x [B, C, X, Y, Z] sampled at
        ``points`` [B, P, 3] in [-1, 1]^3 (with ``sampling_img_feats``,
        ``img_feats`` [B, C_img, H, W] sampled at ``points_uv`` [B, P, 2])
        -> point logits [B, P, classes]."""
        feats = [trilinear_point_sample(x.permute(0, 2, 3, 4, 1), points)]
        if self.sampling_img_feats and img_feats is not None:
            sampled = bilinear_image_sample(img_feats.permute(0, 2, 3, 1),
                                            points_uv)
            feats.append(self.img_feat_reduce(sampled.to(
                self.img_feat_reduce.weight.dtype)))
        if self.soft_weights:
            w = F.relu(self.soft_w1(feats[0]))
            w = torch.softmax(self.soft_w2(w), dim=-1)
            fused = sum(f * w[..., i:i + 1] for i, f in enumerate(feats))
        else:
            fused = sum(feats)
        return self.point_occ_mlp(fused)
