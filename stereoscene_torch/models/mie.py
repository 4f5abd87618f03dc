"""Mutual Interactive Ensemble (MIE), port of
``stereoscene_tpu/models/mie.py``
(ref: ViewTransformerLSSVoxel.py:227-268, attention.py:45-120).

- ``BRIAttention``: confidence-reweighted cross-attention between two
  single-channel depth volumes; its 1x1x1 Q/K/V convs on C=1 volumes are
  scalar affine maps. ``gamma`` is zero-initialised.
- ``CA3D``: channel-attention recalibration (GELU, GN(1)).
- ``VolumeInteraction``: both BRI directions -> conv3d(2->32) -> hourglass
  -> ``alpha``-gated residual CA3D -> conv3d(32->1) -> fp32 depth softmax.

Volumes enter and leave as [B, D, H, W].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bri_attention import confidence_attention
from .layers import GroupNorm
from .stereo_volume import Hourglass3D


class BRIAttention(nn.Module):
    def __init__(self, chunk: int = 1024):
        super().__init__()
        self.chunk = chunk
        self.query_conv = nn.Conv3d(1, 1, 1)
        self.key_conv = nn.Conv3d(1, 1, 1)
        self.value_conv = nn.Conv3d(1, 1, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, q, kv):
        b, d, h, w = q.shape
        conf = torch.softmax(q.float(), dim=1).amax(dim=1).reshape(b, 1, h * w)

        def affine(conv, x):
            return conv.weight.reshape(()) * x + conv.bias.reshape(())

        qf = affine(self.query_conv, q).reshape(b, d, h * w)
        kf = affine(self.key_conv, kv).reshape(b, d, h * w)
        vf = affine(self.value_conv, kv).reshape(b, d, h * w)
        out = confidence_attention(qf, kf, vf * conf.to(vf.dtype),
                                   chunk=self.chunk)
        return self.gamma * out.reshape(b, d, h, w) + kv


class CA3D(nn.Module):
    def __init__(self, channel: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv3d(channel, channel, 3, padding=1), nn.GELU(),
            GroupNorm(1, channel))
        self.conv2 = nn.Sequential(
            nn.Conv3d(channel, channel // 8, 1), nn.GELU(),
            nn.Conv3d(channel // 8, channel, 1), nn.GELU())
        self.conv = nn.Sequential(
            nn.Conv3d(channel, channel, 3, padding=1), nn.GELU(),
            GroupNorm(1, channel))

    def forward(self, x):
        data = self.conv1(x)
        pool = data.float().mean(dim=(2, 3, 4), keepdim=True).to(x.dtype)
        weight = torch.sigmoid(self.conv2(pool))
        return self.conv(weight * data)


class Residual(nn.Module):
    """alpha * fn(x) + x with a zero-initialised ``alpha``."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.alpha * self.fn(x) + x


class VolumeInteraction(nn.Module):
    def __init__(self, channels: int = 32, attention_chunk: int = 1024,
                 conv3d_kernel: bool = False):
        super().__init__()
        self.redir1 = nn.Conv3d(2, channels, 3, padding=1)
        self.dres1 = Hourglass3D(channels, conv3d_kernel)
        self.redir2 = nn.Conv3d(channels, 1, 3, padding=1)
        self.lss2stereo = BRIAttention(attention_chunk)
        self.stereo2lss = BRIAttention(attention_chunk)
        self.CA3D = Residual(CA3D(channels))

    def forward(self, stereo_volume, lss_volume):
        lss_g = self.lss2stereo(q=stereo_volume, kv=lss_volume)
        stereo_g = self.stereo2lss(q=lss_volume, kv=stereo_volume)
        data = F.relu(self.redir1(torch.stack([lss_g, stereo_g], dim=1)))
        data = self.CA3D(self.dres1(data))
        fused = F.relu(self.redir2(data))[:, 0]
        return torch.softmax(fused.float(), dim=1).to(stereo_volume.dtype)
