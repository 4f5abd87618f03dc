"""BEVFormer-style occupancy transformer, port of
``stereoscene_tpu/models/bevformer.py`` (ref: projects/mmdet3d_plugin/
bevformer/modules/: encoder, spatial cross attention, temporal self
attention, transformer).

- ``DeformableAttention``: queries predict per-head sampling offsets (a
  zero-initialised layer) and softmax weights over levels x points (fp32),
  then ``ops.msdeform_attn`` samples the projected values.
- ``SpatialCrossAttention``: each BEV query samples its pillar's points
  projected into every camera; the sum over valid (camera, z) hits is
  divided by their count, floored at 1. The offsets and weights depend on
  the query alone and the projected values on the camera alone, so they
  are computed once and not once per (camera, z) as the JAX package's
  calls do; the samples are the same.
- ``OccupancyEncoderLayer`` / ``OccupancyEncoder``: pre-norm temporal
  self-attention, spatial cross-attention and FFN over learned BEV
  queries; the three LayerNorms compute in fp32 (flax's eps 1e-6).
- ``ego_motion_shift`` / ``rotate_bev``: the reference's can_bus ego
  compensation (ref: transformer.py:121-155).
- ``BEVOccHead``: channel-to-height decoding of the encoded queries.

Tensors are channels-last as in the JAX package ([B, Q, C] queries). The
pillar projection is an elementwise product and sum in fp32, never a
matmul, so it stays exact with TF32 on (the JAX package computes it at
``Precision.HIGHEST``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.msdeform_attn import msdeform_attn


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 and cast back (flax ``nn.LayerNorm(
    dtype=float32)``, eps 1e-6)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class DeformableAttention(nn.Module):
    """Deformable attention over ``num_levels`` value levels."""

    def __init__(self, embed_dim: int, num_heads: int = 4,
                 num_points: int = 4, num_levels: int = 1):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_points = num_points
        self.num_levels = num_levels
        n_total = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dim, n_total * 2)
        nn.init.zeros_(self.sampling_offsets.weight)
        self.attention_weights = nn.Linear(embed_dim, n_total)
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)

    def offsets_and_weights(self, query, spatial_shapes):
        """(offsets over the level sizes [B, Q, heads, L, P, 2] in fp32,
        softmaxed weights [B, Q, heads, L, P] in the query's dtype)."""
        b, q, _ = query.shape
        shape = (b, q, self.num_heads, self.num_levels, self.num_points)
        offsets = self.sampling_offsets(query).reshape(shape + (2,))
        logits = self.attention_weights(query).reshape(
            b, q, self.num_heads, -1)
        weights = torch.softmax(logits.float(), dim=-1).reshape(shape).to(
            query.dtype)
        sizes = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                             dtype=torch.float32, device=query.device)
        return offsets.float() / sizes[:, None, :], weights

    def attend(self, value_proj, spatial_shapes, reference_points, offsets,
               weights):
        """reference_points [B, Q, L, 2] in [0, 1] -> [B, Q, C]."""
        locs = reference_points.float()[:, :, None, :, None, :] + offsets
        out = msdeform_attn(value_proj, spatial_shapes, locs, weights,
                            self.num_heads)
        return self.output_proj(out)

    def forward(self, query, value, spatial_shapes, reference_points):
        """query [B, Q, C]; value [B, sum(HW), C]; reference_points
        [B, Q, num_levels, 2] normalised to [0, 1]."""
        offsets, weights = self.offsets_and_weights(query, spatial_shapes)
        return self.attend(self.value_proj(value), spatial_shapes,
                           reference_points, offsets, weights)


class SpatialCrossAttention(nn.Module):
    """BEV queries sample their projected pillar points in every camera
    (one ``DeformableAttention``, ``deform``, shared by every hit)."""

    def __init__(self, embed_dim: int, num_heads: int = 4,
                 num_points: int = 4, num_z: int = 4, num_levels: int = 1):
        super().__init__()
        self.num_z = num_z
        self.deform = DeformableAttention(embed_dim, num_heads, num_points,
                                          num_levels)

    def forward(self, query, img_feats, spatial_shapes, ref_points_img,
                ref_mask):
        """query [B, Q, C]; img_feats [B, N_cam, sum(HW), C];
        ref_points_img [B, N_cam, Q, num_z, 2] normalised image coords;
        ref_mask [B, N_cam, Q, num_z] validity."""
        b, n_cam = img_feats.shape[:2]
        q = query.shape[1]
        levels = len(spatial_shapes)
        offsets, weights = self.deform.offsets_and_weights(query,
                                                           spatial_shapes)
        total = 0.0
        count = 0.0
        for cam in range(n_cam):
            value = self.deform.value_proj(img_feats[:, cam])
            for zi in range(self.num_z):
                ref = ref_points_img[:, cam, :, zi][:, :, None].expand(
                    b, q, levels, 2)
                out = self.deform.attend(value, spatial_shapes, ref, offsets,
                                         weights)
                m = ref_mask[:, cam, :, zi].to(out.dtype)[..., None]
                total = total + out * m
                count = count + m
        return query + total / torch.clamp(count, min=1.0)


class OccupancyEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4,
                 ffn_ratio: float = 2.0, num_z: int = 4,
                 num_levels: int = 1):
        super().__init__()
        self.norm1 = LayerNorm32(embed_dim)
        self.self_attn = DeformableAttention(embed_dim, num_heads)
        self.norm2 = LayerNorm32(embed_dim)
        self.cross_attn = SpatialCrossAttention(
            embed_dim, num_heads, num_z=num_z, num_levels=num_levels)
        self.norm3 = LayerNorm32(embed_dim)
        hidden = int(embed_dim * ffn_ratio)
        self.ffn1 = nn.Linear(embed_dim, hidden)
        self.ffn2 = nn.Linear(hidden, embed_dim)

    def forward(self, query, bev_shape, img_feats, spatial_shapes,
                ref_points_img, ref_mask, prev_bev=None, shift=None):
        """Temporal self-attention over the BEV grid (against ``prev_bev``
        where given, its sampling points moved by the ego ``shift``), then
        spatial cross-attention, then the FFN (bevformer.py:125-161)."""
        h, w = bev_shape
        b = query.shape[0]
        dev = query.device
        gy, gx = torch.meshgrid(
            (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h,
            (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w,
            indexing="ij")
        self_ref = torch.stack([gx, gy], -1).reshape(1, h * w, 1, 2).expand(
            b, h * w, 1, 2)
        if prev_bev is not None and shift is not None:
            self_ref = self_ref + shift.float()[:, None, None, :]
        value = prev_bev if prev_bev is not None else query
        y = self.self_attn(self.norm1(query), value, [(h, w)], self_ref)
        query = query + y
        query = self.cross_attn(self.norm2(query), img_feats, spatial_shapes,
                                ref_points_img, ref_mask)
        y = self.ffn2(F.relu(self.ffn1(self.norm3(query))))
        return query + y


def ego_motion_shift(can_bus: torch.Tensor, bev_shape: Tuple[int, int],
                     grid_length: Tuple[float, float],
                     use_shift: bool = True) -> torch.Tensor:
    """Normalised BEV shift [B, 2] (shift_x, shift_y) of the ego between
    frames from can_bus [B, 18]: delta position in [0:2], yaw (radians) in
    [-2] (ref: transformer.py:121-140)."""
    h, w = bev_shape
    delta_x, delta_y = can_bus[:, 0], can_bus[:, 1]
    ego_angle = can_bus[:, -2] / math.pi * 180.0
    translation_length = torch.sqrt(delta_x ** 2 + delta_y ** 2)
    translation_angle = torch.atan2(delta_y, delta_x) / math.pi * 180.0
    bev_angle = ego_angle - translation_angle
    shift_y = (translation_length * torch.cos(bev_angle / 180.0 * math.pi)
               / grid_length[0] / h)
    shift_x = (translation_length * torch.sin(bev_angle / 180.0 * math.pi)
               / grid_length[1] / w)
    scale = 1.0 if use_shift else 0.0
    return torch.stack([shift_x * scale, shift_y * scale], dim=-1)


def rotate_bev(prev_bev: torch.Tensor, angle_deg: torch.Tensor,
               bev_shape: Tuple[int, int]) -> torch.Tensor:
    """Rotate flattened BEV features [B, H*W, C] counterclockwise by
    ``angle_deg`` [B] about the grid centre, bilinear with zero fill (the
    reference's torchvision ``rotate``, transformer.py:142-155)."""
    h, w = bev_shape
    b, q, c = prev_bev.shape
    dev = prev_bev.device
    grid = prev_bev.reshape(b, h * w, c)
    theta = (angle_deg.float() * math.pi / 180.0)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    cos, sin = torch.cos(theta), torch.sin(theta)
    sx = cos * (xs - cx) - sin * (ys - cy) + cx
    sy = sin * (xs - cx) + cos * (ys - cy) + cy
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()

    def tap(yy, xx, wgt):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        val = grid.gather(1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return val * (inside.to(grid.dtype) * wgt).reshape(b, -1, 1)

    return (tap(y0, x0, (1 - fy) * (1 - fx))
            + tap(y0, x0 + 1, (1 - fy) * fx)
            + tap(y0 + 1, x0, fy * (1 - fx))
            + tap(y0 + 1, x0 + 1, fy * fx))


class OccupancyEncoder(nn.Module):
    """Learned BEV queries refined by stacked encoder layers.

    ``can_bus`` builds the can_bus MLP (``can_bus_mlp1`` / ``mlp2`` /
    ``norm``) for a caller that passes can_bus signals; flax creates those
    parameters on the first call that uses them, so a model that never
    passes can_bus (BEVOcc) has none."""

    def __init__(self, embed_dim: int = 128, num_layers: int = 3,
                 bev_shape: Tuple[int, int] = (64, 64), num_z: int = 4,
                 pc_range: Sequence[float] = (0, -25.6, -2, 51.2, 25.6, 4.4),
                 use_can_bus: bool = True, can_bus_norm: bool = True,
                 rotate_prev_bev: bool = True, use_shift: bool = True,
                 can_bus: bool = False, num_levels: int = 1):
        super().__init__()
        self.embed_dim = embed_dim
        self.bev_shape = tuple(bev_shape)
        self.num_z = num_z
        self.pc_range = tuple(float(v) for v in pc_range)
        self.use_can_bus = use_can_bus
        self.norm_can_bus = can_bus_norm
        self.rotate_prev_bev = rotate_prev_bev
        self.use_shift = use_shift
        h, w = self.bev_shape
        self.bev_queries = nn.Parameter(torch.randn(h * w, embed_dim) * 0.02)
        if can_bus and use_can_bus:
            self.can_bus_mlp1 = nn.Linear(18, embed_dim)
            self.can_bus_mlp2 = nn.Linear(embed_dim, embed_dim)
            if can_bus_norm:
                self.can_bus_norm = LayerNorm32(embed_dim)
        self.num_layers = num_layers
        for i in range(num_layers):  # keys ``layer{i}``, the JAX names
            setattr(self, f"layer{i}", OccupancyEncoderLayer(
                embed_dim, num_z=num_z, num_levels=num_levels))
        self.register_buffer(
            "ref_points", torch.from_numpy(self.ref_pillar_points()),
            persistent=False)

    def ref_pillar_points(self) -> np.ndarray:
        """3D reference pillar points per BEV cell: [Q, num_z, 3] ego xyz
        (cell centres)."""
        h, w = self.bev_shape
        lo = np.asarray(self.pc_range[:3], np.float32)
        hi = np.asarray(self.pc_range[3:], np.float32)
        xs = lo[0] + (np.arange(h) + 0.5) * (hi[0] - lo[0]) / h
        ys = lo[1] + (np.arange(w) + 0.5) * (hi[1] - lo[1]) / w
        zs = lo[2] + (np.arange(self.num_z) + 0.5) * (hi[2] - lo[2]) \
            / self.num_z
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        return np.stack([gx, gy, gz], -1).reshape(
            h * w, self.num_z, 3).astype(np.float32)

    def project(self, lidar2img, img_size):
        """Pillar points in every camera: (normalised image coordinates
        [B, N_cam, Q, Z, 2], validity [B, N_cam, Q, Z]); depth clamped as
        max(|d|, 1e-5), valid where d > 0.1 and inside the image."""
        pts = self.ref_points
        homo = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        l2i = lidar2img.float()
        pix = (l2i[:, :, None, None] * homo[None, None, :, :, None, :]).sum(-1)
        depth = pix[..., 2]
        uv = pix[..., :2] / torch.clamp(depth.abs()[..., None], min=1e-5)
        ih, iw = img_size
        ref = torch.stack([uv[..., 0] / iw, uv[..., 1] / ih], dim=-1)
        mask = ((depth > 0.1) & (ref[..., 0] > 0) & (ref[..., 0] < 1)
                & (ref[..., 1] > 0) & (ref[..., 1] < 1))
        return ref, mask

    def forward(self, img_feats, spatial_shapes, lidar2img, img_size,
                prev_bev=None, query_pos=None, can_bus=None):
        """img_feats [B, N_cam, sum(HW), C]; lidar2img [B, N_cam, 3, 4]
        (P @ Tr); img_size (H, W) of the raw image; query_pos optional
        [Q, C] added to the BEV queries; can_bus optional [B, 18] (needs
        ``can_bus=True`` at construction). Returns [B, Q, C]."""
        b = img_feats.shape[0]
        h, w = self.bev_shape
        queries = self.bev_queries
        if query_pos is not None:
            queries = queries + query_pos.to(queries.dtype)
        query = queries[None].expand(b, h * w, self.embed_dim).to(
            img_feats.dtype)
        shift = torch.zeros((b, 2), dtype=torch.float32,
                            device=img_feats.device)
        if can_bus is not None:
            can_bus = can_bus.float()
            grid_length = ((self.pc_range[4] - self.pc_range[1]) / h,
                           (self.pc_range[3] - self.pc_range[0]) / w)
            shift = ego_motion_shift(can_bus, self.bev_shape, grid_length,
                                     self.use_shift)
            if prev_bev is not None and self.rotate_prev_bev:
                prev_bev = rotate_bev(prev_bev, can_bus[:, -1],
                                      self.bev_shape)
            if self.use_can_bus:
                y = F.relu(self.can_bus_mlp1(can_bus))
                y = F.relu(self.can_bus_mlp2(y))
                if self.norm_can_bus:
                    y = self.can_bus_norm(y)
                query = query + y[:, None, :].to(query.dtype)
        ref_img, mask = self.project(lidar2img, img_size)
        for i in range(self.num_layers):
            query = getattr(self, f"layer{i}")(
                query, self.bev_shape, img_feats, spatial_shapes, ref_img,
                mask, prev_bev=prev_bev, shift=shift)
        return query


class BEVOccHead(nn.Module):
    """Encoded BEV queries [B, H*W, C] -> voxel logits [B, H, W, Z, K]."""

    def __init__(self, embed_dim: int = 128,
                 bev_shape: Tuple[int, int] = (64, 64), num_z: int = 8,
                 out_channel: int = 20):
        super().__init__()
        self.bev_shape = tuple(bev_shape)
        self.num_z = num_z
        self.out_channel = out_channel
        self.decoder1 = nn.Linear(embed_dim, embed_dim * 2)
        self.decoder2 = nn.Linear(embed_dim * 2, num_z * out_channel)

    def forward(self, bev_queries):
        b = bev_queries.shape[0]
        h, w = self.bev_shape
        y = self.decoder2(F.relu(self.decoder1(bev_queries)))
        return y.reshape(b, h, w, self.num_z, self.out_channel)
