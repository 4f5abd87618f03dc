"""BEVStereo-style multi-view-stereo depth, port of
``stereoscene_tpu/models/bev_stereo.py`` (ref: ViewTransformerLSSBEVDepth
.py:805-1410, ``DepthNetStereo`` and ``homo_warping``).

- ``DepthNetStereo``: a camera-aware depth net giving context, mono depth
  logits, the stereo matching features and per-range Gaussian parameters
  (mu, sigma, range score) at 4x the feature resolution. Its
  ``DeformConvPack`` runs the DCN gather kernel P1 on the card.
- ``homo_warp``: the adjacent frame's features warped onto key-frame
  pixels at candidate depths (plane sweep), sampled with the DCN's
  ``bilinear_sample_nhwc``; a point behind the source camera (depth
  <= 1e-3) samples at the -1e4 sentinel, so it reads zeros.
- ``StereoSimilarityNet``: group correlation of key and warped features
  scored per candidate.
- ``gaussian_depth_candidates``, ``em_refine``,
  ``depth_distribution_from_gaussian``: candidates from (mu, sigma),
  fixed-count EM refinement, and the refined Gaussian on the LSS bins.

``DepthNetStereo`` is channels-first like the port's ``DepthNet``; the
functions keep the JAX package's channels-last layouts. The small
projective products are fp32 elementwise sums, never TF32 matmuls (the
JAX package computes them at ``Precision.HIGHEST``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import bilinear_sample_nhwc
from .depth_net import ASPP, BasicBlock2d, DeformConvPack
from .layers import BatchNorm, GroupNorm, Mlp, SELayer


class DepthNetStereo(nn.Module):
    """[N, C_in, H, W] + [N, cam] -> context, mono depth, stereo features
    (at H x W) and mu / sigma / range_score (at 4H x 4W), channels-first
    (ref: ViewTransformerLSSBEVDepth.py:805-920). Keys follow the JAX
    module names; the blocks, ASPP and DCN are the port's ``DepthNet``
    modules."""

    def __init__(self, in_channels: int, mid_channels: int,
                 context_channels: int, depth_channels: int,
                 cam_channels: int = 27, num_ranges: int = 4):
        super().__init__()
        mid = mid_channels
        self.num_ranges = num_ranges
        self.bn = GroupNorm(1, cam_channels)
        self.reduce_conv = nn.Conv2d(in_channels, mid, 3, padding=1)
        self.reduce_bn = BatchNorm(mid)
        self.context_mlp = Mlp(cam_channels, mid, mid)
        self.context_se = SELayer(mid)
        self.context_conv = nn.Conv2d(mid, context_channels, 1)
        self.depth_mlp = Mlp(cam_channels, mid, mid)
        self.depth_se = SELayer(mid)
        self.block0 = BasicBlock2d(mid)
        self.block1 = BasicBlock2d(mid)
        self.aspp = ASPP(mid, mid)
        self.dcn = DeformConvPack(mid)
        self.mono_block = BasicBlock2d(mid)
        self.mono_head = nn.Conv2d(mid, depth_channels, 1)
        self.ms_block = BasicBlock2d(mid)
        for i in range(2):
            setattr(self, f"ms_up{i}", nn.ConvTranspose2d(
                mid, mid, 3, stride=2, padding=1, output_padding=1))
            setattr(self, f"ms_bn{i}", BatchNorm(mid))
        self.ms_head = nn.Conv2d(mid, num_ranges * 3, 1)

    def forward(self, x, mlp_input, generator=None,
                use_kernel=None) -> Dict[str, torch.Tensor]:
        """``generator`` seeds the ASPP dropout in training mode;
        ``use_kernel`` goes to the DCN (P1)."""
        mlp_input = self.bn(mlp_input.reshape(-1, mlp_input.shape[-1]))
        y = F.relu(self.reduce_bn(self.reduce_conv(x)))
        context = self.context_conv(
            self.context_se(y, self.context_mlp(mlp_input)))
        feat = self.depth_se(y, self.depth_mlp(mlp_input))
        feat = self.block1(self.block0(feat))
        feat = self.dcn(self.aspp(feat, generator), use_kernel)
        mono_depth = self.mono_head(self.mono_block(feat))
        ms = self.ms_block(feat)
        for i in range(2):
            ms = F.relu(getattr(self, f"ms_bn{i}")(
                getattr(self, f"ms_up{i}")(ms)))
        ms = self.ms_head(ms)
        r = self.num_ranges
        return {"context": context, "mono_depth": mono_depth,
                "stereo_feat": feat, "mu": ms[:, :r],
                "sigma": ms[:, r:2 * r], "range_score": ms[:, 2 * r:]}


def _apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m [..., i, j] applied to vectors v [..., j] as an fp32 sum."""
    return (m.float() * v.float()[..., None, :]).sum(-1)


def homo_warp(src_feat: torch.Tensor, key2src: torch.Tensor,
              key_intrin: torch.Tensor, src_intrin: torch.Tensor,
              depth_samples: torch.Tensor) -> torch.Tensor:
    """Warp the source frame's features [B, H, W, C] onto key-frame pixels
    at the candidate depths [B, K, H, W] (key2src [B, 4, 4], intrinsics
    [B, 3, 3] at feature resolution; ref homo_warping :1021-1099 without
    IDA). Returns [B, K, H, W, C], zero outside the source image."""
    b, h, w, c = src_feat.shape
    k = depth_samples.shape[1]
    dev = src_feat.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([gx, gy, torch.ones_like(gx)], -1)  # [H, W, 3]
    inv_k = torch.linalg.inv(key_intrin.float())
    rays = _apply(inv_k[:, None, None], pix[None])  # [B, H, W, 3]
    pts = rays[:, None] * depth_samples.float()[..., None]
    homo = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    src_pts = _apply(key2src[:, None, None, None], homo)[..., :3]
    src_pix = _apply(src_intrin[:, None, None, None], src_pts)
    depth = src_pix[..., 2]
    valid = depth > 1e-3
    den = torch.clamp(depth, min=1e-3)
    u = torch.where(valid, src_pix[..., 0] / den, -1e4)
    v = torch.where(valid, src_pix[..., 1] / den, -1e4)
    out = bilinear_sample_nhwc(src_feat, v.reshape(b, k * h, w),
                               u.reshape(b, k * h, w))
    return out.reshape(b, k, h, w, c)


class StereoSimilarityNet(nn.Module):
    """Group correlation of key features [B, H, W, C] with warped ones
    [B, K, H, W, C] -> scores [B, K, H, W] (ref similarity_net)."""

    def __init__(self, num_groups: int = 8):
        super().__init__()
        self.num_groups = num_groups
        self.fc1 = nn.Linear(num_groups, num_groups)
        self.fc2 = nn.Linear(num_groups, 1)

    def forward(self, key_feat, warped):
        b, k, h, w, c = warped.shape
        g = self.num_groups
        corr = (key_feat.reshape(b, 1, h, w, g, c // g)
                * warped.reshape(b, k, h, w, g, c // g)).mean(-1)
        return self.fc2(F.relu(self.fc1(corr)))[..., 0]


def gaussian_depth_candidates(mu: torch.Tensor, sigma: torch.Tensor,
                              num_samples: int,
                              d_bound: Tuple[float, float, float]
                              ) -> torch.Tensor:
    """K candidates per pixel from (mu, sigma) [B, H, W]: the centre
    sigmoid(mu) across the depth range, the spread softplus(sigma) + 0.5,
    offsets linspace(-2, 2) -> [B, K, H, W]."""
    lo, hi, _ = d_bound
    center = lo + torch.sigmoid(mu.float()) * (hi - lo)
    spread = F.softplus(sigma.float()) + 0.5
    offsets = torch.linspace(-2.0, 2.0, num_samples, device=mu.device)
    return center[:, None] + offsets[None, :, None, None] * spread[:, None]


def em_refine(mu: torch.Tensor, sigma: torch.Tensor, candidates: torch.Tensor,
              scores: torch.Tensor,
              iters: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` EM steps: weights softmax(score - (d - mu)^2 / 2 sigma^2)
    over the candidates, then mu and sigma re-estimated from them."""
    mu, sigma = mu.float(), sigma.float()
    for _ in range(iters):
        logp = scores.float() - ((candidates - mu[:, None]) ** 2
                                 / (2 * sigma[:, None] ** 2 + 1e-6))
        wgt = torch.softmax(logp, dim=1)
        mu = (wgt * candidates).sum(1)
        var = (wgt * (candidates - mu[:, None]) ** 2).sum(1)
        sigma = torch.sqrt(var + 1e-6)
    return mu, sigma


def depth_distribution_from_gaussian(mu: torch.Tensor, sigma: torch.Tensor,
                                     d_bound: Tuple[float, float, float],
                                     num_depth: int) -> torch.Tensor:
    """The refined Gaussian [B, H, W] on the LSS depth bins ->
    [B, D, H, W]."""
    lo, _, step = d_bound
    centers = lo + step * torch.arange(num_depth, dtype=torch.float32,
                                       device=mu.device)
    z = (centers[None, :, None, None] - mu[:, None]) / (sigma[:, None] + 1e-6)
    return torch.softmax(-0.5 * z ** 2, dim=1)
