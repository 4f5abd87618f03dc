"""The plain reference of the StereoScene detector: a frozen copy of the
program's plain route for the published configuration, written with plain
``torch`` operations only, in float32 (the caller turns TF32 off).

EfficientNet (b family) + SECONDFPN over both eyes; the stereo branch
(camera-aware matching features, group-wise correlation volume warped to
the depth bins, dres0 / dres1 and three hourglasses); the camera-aware
DepthNet (3 BasicBlocks, ASPP, DCNv1 as gather-then-matmul); the MIE
(both BRI attentions, the hourglass, CA3D); the lift and splat as an
``index_add`` over per-point voxel ranks the reference computes itself;
ResNet3D (BasicBlocks, GroupNorm), SECONDFPN3D and the OccHead voxel
branch; the trilinear upsample to the label grid.

Parameter names follow the reference checkpoint layout, which the program
follows too, so one ``state_dict`` loads into both. Randomness in training
mode (DropPath over the image backbone's blocks, the ASPP's dropout) is
drawn from a caller's ``torch.Generator`` in the program's order and
shapes, so both sides draw the same masks from one seed.

``set_quantizer`` routes every convolution, linear layer and attention or
DCN product through a quantize-dequantize function: the control of the
benchmark's comparison runs the reference in a lower precision that way.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import geometry


def _identity(x):
    return x


class _Q:
    """Mixin: ``self.q`` quantizes a product's operands (identity unless
    ``set_quantizer`` set one)."""

    q: Callable = staticmethod(_identity)


class Conv2d(_Q, nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(self.q(x), self.q(self.weight), self.bias)


class Conv3d(_Q, nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(self.q(x), self.q(self.weight), self.bias)


class ConvTranspose2d(_Q, nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(self.q(x), self.q(self.weight), self.bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class ConvTranspose3d(_Q, nn.ConvTranspose3d):
    def forward(self, x):
        return F.conv_transpose3d(self.q(x), self.q(self.weight), self.bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class Linear(_Q, nn.Linear):
    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


def set_quantizer(model: nn.Module, fn: Callable) -> None:
    """Route every product of ``model`` through ``fn``."""
    for m in model.modules():
        if isinstance(m, _Q):
            m.q = fn


def keep_mask(shape, keep: float, generator, device,
              groups: int = 1) -> torch.Tensor:
    """Bernoulli(``keep``) mask drawn as the program draws it: one
    ``torch.rand`` of ``(groups, n) + shape[1:]`` on the generator's
    device."""
    gen_device = generator.device if generator is not None else device
    n = shape[0] // groups
    draw = torch.rand((groups, n) + tuple(shape[1:]), generator=generator,
                      device=gen_device).reshape(shape)
    return (draw < keep).to(device)


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        b, c = x.shape[:2]
        rows = x.reshape(b, self.num_groups, -1)
        var, mean = torch.var_mean(rows, dim=-1, correction=0, keepdim=True)
        y = ((rows - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        affine = (1, c) + (1,) * (x.dim() - 2)
        return y * self.weight.reshape(affine) + self.bias.reshape(affine)


class BatchNorm(nn.BatchNorm2d):
    """Eval: running statistics. Training: the batch's mean and biased
    variance (running statistics are not compared and not updated)."""

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x, dim=dims, correction=0)
        else:
            var, mean = self.running_var, self.running_mean
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                    + self.eps)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


# ---------------------------------------------------------------- images

_BASE_BLOCKS = [
    [(3, 16, 4, 1, 1)],
    [(3, 24, 4, 2, 6), (3, 24, 4, 1, 6)],
    [(5, 40, 4, 2, 6), (5, 40, 4, 1, 6)],
    [(3, 80, 4, 2, 6), (3, 80, 4, 1, 6), (3, 80, 4, 1, 6),
     (5, 112, 4, 1, 6), (5, 112, 4, 1, 6), (5, 112, 4, 1, 6)],
    [(5, 192, 4, 2, 6), (5, 192, 4, 1, 6), (5, 192, 4, 1, 6),
     (5, 192, 4, 1, 6), (3, 320, 4, 1, 6)],
]
_ARCH = {"b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2),
         "b3": (1.2, 1.4), "b4": (1.4, 1.8), "b5": (1.6, 2.2),
         "b6": (1.8, 2.6), "b7": (2.0, 3.1), "b8": (2.2, 3.6)}


def _divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def efficientnet_stages(arch: str):
    """(stem width, stages of (kernel, width, se, stride, expand), head
    width) after compound scaling (mmcls ``model_scaling``)."""
    w, d = _ARCH[arch]
    segments = []
    for group in _BASE_BLOCKS:
        current = []
        for k, c, se, s, e in group:
            c = _divisible(c * w)
            if current and current[-1][1] != c:
                segments.append(current)
                current = []
            current.append((k, c, se, s, e))
        segments.append(current)
    stages = []
    for i, seg in enumerate(segments):
        n = int(math.ceil(d * len(seg)))
        blocks = seg[:n] if n <= len(seg) else seg + [seg[-1]] * (n - len(seg))
        if i > 0 and blocks[0][3] == 1:
            stages[-1] = stages[-1] + blocks
        else:
            stages.append(list(blocks))
    return _divisible(32 * w), stages, int(1280 * w)


class SameConv2d(Conv2d):
    """TF-SAME padding."""

    def forward(self, x):
        ih, iw = x.shape[-2:]
        kh, kw = self.weight.shape[-2:]
        sh, sw = self.stride
        ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
        pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return F.conv2d(self.q(x), self.q(self.weight), self.bias,
                        self.stride, 0, self.dilation, self.groups)


class ConvBNAct(nn.Module):
    def __init__(self, cin, cout, k, stride=1, groups=1, act=True):
        super().__init__()
        self.conv = SameConv2d(cin, cout, k, stride=stride, groups=groups,
                               bias=False)
        self.bn = BatchNorm(cout, eps=1e-3)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class SqueezeExcite(nn.Module):
    def __init__(self, channels, squeeze):
        super().__init__()
        self.conv1 = nn.Module()
        self.conv1.conv = Conv2d(channels, squeeze, 1)
        self.conv2 = nn.Module()
        self.conv2.conv = Conv2d(squeeze, channels, 1)

    def forward(self, x):
        s = F.silu(self.conv1.conv(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv2.conv(s))


class MBConv(nn.Module):
    def __init__(self, cin, cout, kernel, stride, expand, se_ratio,
                 drop_path_rate):
        super().__init__()
        mid = cin * expand
        self.with_res = stride == 1 and cin == cout
        self.drop_path_rate = drop_path_rate
        self.expand_conv = ConvBNAct(cin, mid, 1) if mid != cin else None
        self.depthwise_conv = ConvBNAct(mid, mid, kernel, stride=stride,
                                        groups=mid)
        self.se = SqueezeExcite(mid, max(1, int(mid // (expand * se_ratio))))
        self.linear_conv = ConvBNAct(mid, cout, 1, act=False)

    def forward(self, x, keep):
        out = x if self.expand_conv is None else self.expand_conv(x)
        out = self.linear_conv(self.se(self.depthwise_conv(out)))
        if not self.with_res:
            return out
        if keep is not None:
            mask = keep.reshape((-1,) + (1,) * (out.dim() - 1))
            out = torch.where(mask, out / (1.0 - self.drop_path_rate),
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
        return x + out

    def drop_mask(self, x, generator, groups):
        if not (self.training and self.with_res and self.drop_path_rate > 0):
            return None
        return keep_mask((x.shape[0],), 1.0 - self.drop_path_rate, generator,
                         x.device, groups)


class EfficientNet(nn.Module):
    def __init__(self, arch, out_indices, drop_path_rate):
        super().__init__()
        stem, stages, head = efficientnet_stages(arch)
        self.out_indices = tuple(out_indices)
        total = sum(len(s) for s in stages)
        rates = iter(drop_path_rate * i / max(total - 1, 1)
                     for i in range(total))
        layers = [ConvBNAct(3, stem, 3, stride=2)]
        cin = stem
        for stage in stages:
            blocks = []
            for k, c, se, s, e in stage:
                blocks.append(MBConv(cin, c, k, s, e, se, next(rates)))
                cin = c
            layers.append(nn.Sequential(*blocks))
        layers.append(ConvBNAct(cin, head, 1))
        self.layers = nn.ModuleList(layers)
        self.checkpoint_blocks = False

    def forward(self, x, generator=None, groups=1):
        outs = []
        for i, layer in enumerate(self.layers):
            if i > max(self.out_indices):
                break
            if isinstance(layer, nn.Sequential):
                for block in layer:
                    keep = block.drop_mask(x, generator, groups)
                    if self.checkpoint_blocks and torch.is_grad_enabled():
                        x = checkpoint(block, x, keep, use_reentrant=False)
                    else:
                        x = block(x, keep)
            else:
                x = layer(x)
            if i in self.out_indices:
                outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    def __init__(self, in_channels, out_channels, upsample_strides):
        super().__init__()
        blocks = []
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            if s >= 1:
                up = ConvTranspose2d(cin, cout, int(s), stride=int(s),
                                     bias=False)
            else:
                k = int(round(1 / s))
                up = Conv2d(cin, cout, k, stride=k, bias=False)
            blocks.append(nn.Sequential(up, BatchNorm(cout, eps=1e-3),
                                        nn.ReLU()))
        self.deblocks = nn.ModuleList(blocks)

    def forward(self, feats):
        return torch.cat([d(f) for d, f in zip(self.deblocks, feats)], dim=1)


# ------------------------------------------------------------------ view

class Mlp(nn.Module):
    def __init__(self, cin, hidden, cout):
        super().__init__()
        self.fc1 = Linear(cin, hidden)
        self.fc2 = Linear(hidden, cout)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv_reduce = Conv2d(channels, channels, 1)
        self.conv_expand = Conv2d(channels, channels, 1)

    def forward(self, x, x_se):
        s = F.relu(self.conv_reduce(x_se[:, :, None, None]))
        return x * torch.sigmoid(self.conv_expand(s))


def conv_gn3d(cin, cout, k=3, stride=1, padding=1, groups=2):
    return nn.Sequential(Conv3d(cin, cout, k, stride=stride, padding=padding,
                                bias=False), GroupNorm(groups, cout))


class StereoFeatureNet(nn.Module):
    def __init__(self, cin, mid=128, depth=64, cam=30):
        super().__init__()
        self.reduce_conv = nn.Sequential(Conv2d(cin, mid, 3, padding=1),
                                         GroupNorm(2, mid), nn.ReLU())
        self.depth_mlp = Mlp(cam, mid, mid)
        self.depth_se = SELayer(mid)
        self.depth_conv = nn.Sequential(Conv2d(mid, depth, 1))

    def forward(self, x, mlp_input):
        y = self.reduce_conv(x)
        return self.depth_conv(self.depth_se(y, self.depth_mlp(mlp_input)))


class Hourglass3D(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Sequential(conv_gn3d(c, 2 * c, 3, 2, 1), nn.ReLU())
        self.conv2 = nn.Sequential(conv_gn3d(2 * c, 2 * c), nn.ReLU())
        self.conv3 = nn.Sequential(conv_gn3d(2 * c, 4 * c, 3, 2, 1),
                                   nn.ReLU())
        self.conv4 = nn.Sequential(conv_gn3d(4 * c, 4 * c), nn.ReLU())
        self.conv5 = nn.Sequential(
            ConvTranspose3d(4 * c, 2 * c, 3, stride=2, padding=1,
                            output_padding=1, bias=False),
            BatchNorm(2 * c))
        self.conv6 = nn.Sequential(
            ConvTranspose3d(2 * c, c, 3, stride=2, padding=1,
                            output_padding=1, bias=False),
            BatchNorm(c))
        self.redir1 = conv_gn3d(c, c, 1, 1, 0)
        self.redir2 = conv_gn3d(2 * c, 2 * c, 1, 1, 0)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c4 = self.conv4(self.conv3(c2))
        c5 = F.relu(self.conv5(c4) + self.redir2(c2))
        return F.relu(self.conv6(c5) + self.redir1(x))


def gwc_warp(left, right, positions, max_disp, num_groups):
    """Group-wise correlation volume [B, D, H, W, G] (mean over each
    group's channels of left x right shifted by the disparity, zero where
    the shift leaves the image), resampled linearly along the disparity
    axis at ``positions`` [B, K] (zero outside [0, D-1]) -> [B, K, H, W, G]
    (ref: ViewTransformerLSSVoxel.py:97-156)."""
    b, h, w, c = left.shape
    cpg = c // num_groups
    vol = left.new_zeros(b, max_disp, h, w, num_groups)
    for i in range(min(max_disp, w)):
        prod = left[:, :, i:] * right[:, :, :w - i]
        vol[:, i, :, i:] = prod.reshape(b, h, w - i, num_groups,
                                        cpg).mean(-1)
    pos = positions.float()
    i0 = torch.floor(pos).long()
    w1 = pos - i0.float()
    w0 = 1.0 - w1
    w0 = w0 * ((i0 >= 0) & (i0 <= max_disp - 1)).float()
    w1 = w1 * ((i0 + 1 >= 0) & (i0 + 1 <= max_disp - 1)).float()
    bidx = torch.arange(b, device=left.device)[:, None]
    g0 = vol[bidx, i0.clamp(0, max_disp - 1)]
    g1 = vol[bidx, (i0 + 1).clamp(0, max_disp - 1)]
    return g0 * w0[..., None, None, None] + g1 * w1[..., None, None, None]


class GwcVolumeEncoder(nn.Module):
    def __init__(self, max_disp, cin, out_channels=32, num_groups=32,
                 cam=30):
        super().__init__()
        self.max_disp = max_disp
        self.num_groups = num_groups
        self.feature_withcam = StereoFeatureNet(cin, 128, 64, cam)
        self.dres0 = nn.Sequential(conv_gn3d(num_groups, 32), nn.ReLU(),
                                   conv_gn3d(32, 32), nn.ReLU())
        self.dres1 = nn.Sequential(conv_gn3d(32, 32), nn.ReLU(),
                                   conv_gn3d(32, 32))
        self.dres2 = Hourglass3D(32)
        self.dres3 = Hourglass3D(32)
        self.dres4 = Hourglass3D(32)
        self.classif3_1 = nn.Sequential(conv_gn3d(32, out_channels),
                                        nn.ReLU())
        self.classif3_2 = nn.Sequential(
            Conv3d(out_channels, 1, 3, padding=1, bias=False))

    def forward(self, left, right, mlp_left, mlp_right, calib):
        b = left.shape[0]
        match = self.feature_withcam(torch.cat([left, right], 0),
                                     torch.cat([mlp_left, mlp_right], 0))
        match = match.permute(0, 2, 3, 1)
        pos = geometry.disparity_positions(calib, self.max_disp)
        vol = gwc_warp(self.q_(match[:b]), self.q_(match[b:]), pos,
                       self.max_disp, self.num_groups)
        cost0 = self.dres0(vol.permute(0, 4, 1, 2, 3))
        cost0 = self.dres1(cost0) + cost0
        out3 = self.dres4(self.dres3(self.dres2(cost0)))
        single = self.classif3_2(self.classif3_1(out3))[:, 0]
        return torch.softmax(single, dim=1)

    def q_(self, x):
        return self.classif3_2[0].q(x)


class BasicBlock2d(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = Conv2d(c, c, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(c)
        self.conv2 = Conv2d(c, c, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(c)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class ASPPBranch(nn.Module):
    def __init__(self, cin, cout, k, padding, dilation):
        super().__init__()
        self.atrous_conv = Conv2d(cin, cout, k, padding=padding,
                                  dilation=dilation, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    def __init__(self, cin, mid, dropout_rate=0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.aspp1 = ASPPBranch(cin, mid, 1, 0, 1)
        self.aspp2 = ASPPBranch(cin, mid, 3, 6, 6)
        self.aspp3 = ASPPBranch(cin, mid, 3, 12, 12)
        self.aspp4 = ASPPBranch(cin, mid, 3, 18, 18)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)), Conv2d(cin, mid, 1, bias=False),
            GroupNorm(2, mid), nn.ReLU())
        self.conv1 = Conv2d(mid * 5, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)

    def forward(self, x, generator=None):
        xs = [self.aspp1(x), self.aspp2(x), self.aspp3(x), self.aspp4(x)]
        xs.append(self.global_avg_pool(x).expand(-1, -1, *xs[0].shape[-2:]))
        y = F.relu(self.bn1(self.conv1(torch.cat(xs, dim=1))))
        if self.training and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            n, _, h, w = x.shape
            mask = keep_mask((n, y.shape[1], h, w), keep, generator,
                             x.device)
            y = torch.where(mask, y / keep, torch.zeros((), dtype=y.dtype,
                                                        device=y.device))
        return y


def bilinear_sample(img, y, x):
    """[B, H, W, C] at fractional (y, x) [B, Ho, Wo], zero padding."""
    b, h, w, c = img.shape
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    y0i, x0i = y0.long(), x0.long()
    flat = img.reshape(b, h * w, c)
    bidx = torch.arange(b, device=img.device)[:, None]

    def corner(yi, xi, wgt):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        got = flat[bidx, idx].reshape(*yi.shape, c)
        return got * (wgt * inside.to(img.dtype))[..., None]

    out = corner(y0i, x0i, (1 - wy1) * (1 - wx1))
    out = out + corner(y0i, x0i + 1, (1 - wy1) * wx1)
    out = out + corner(y0i + 1, x0i, wy1 * (1 - wx1))
    return out + corner(y0i + 1, x0i + 1, wy1 * wx1)


class DeformConvPack(nn.Module):
    """DCNv1, 3x3, stride 1, padding 1, 4 groups, no bias (mmcv
    DeformConv2dPack): per tap a bilinear gather at the learned offsets,
    then the tap's grouped product."""

    def __init__(self, c, groups=4):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(c, c // groups, 3, 3))
        self.conv_offset = Conv2d(c, 18, 3, padding=1)

    def forward(self, x):
        offsets = self.conv_offset(x).permute(0, 2, 3, 1)
        x = x.permute(0, 2, 3, 1)
        b, h, w, cin = x.shape
        cout, cing = self.weight.shape[:2]
        g = self.groups
        taps = self.conv_offset.q(self.weight).reshape(cout, cing, 9) \
            .permute(2, 1, 0).reshape(9, cing, g, cout // g)
        dev = x.device
        base_y = torch.arange(h, dtype=torch.float32, device=dev)[None, :,
                                                                   None]
        base_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None]
        off = offsets.reshape(b, h, w, 9, 2)
        out = None
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            sy = base_y + (ky - 1) + off[..., tap, 0]
            sx = base_x + (kx - 1) + off[..., tap, 1]
            sampled = self.conv_offset.q(bilinear_sample(x, sy, sx)) \
                .reshape(b, h, w, g, cing)
            y = torch.einsum("bhwgi,igo->bhwgo", sampled, taps[tap]).reshape(
                b, h, w, cout)
            out = y if out is None else out + y
        return out.permute(0, 3, 1, 2)


class DepthNet(nn.Module):
    def __init__(self, cin, mid, context, depth, cam=30):
        super().__init__()
        self.reduce_conv = nn.Sequential(Conv2d(cin, mid, 3, padding=1),
                                         GroupNorm(2, mid), nn.ReLU())
        self.context_conv = Conv2d(mid, context, 1)
        self.bn = GroupNorm(2, cam)
        self.depth_mlp = Mlp(cam, mid, mid)
        self.depth_se = SELayer(mid)
        self.context_mlp = Mlp(cam, mid, mid)
        self.context_se = SELayer(mid)
        self.depth_conv = nn.Sequential(
            BasicBlock2d(mid), BasicBlock2d(mid), BasicBlock2d(mid),
            ASPP(mid, mid), DeformConvPack(mid), Conv2d(mid, depth, 1))

    def forward(self, x, mlp_input, generator=None):
        mlp_input = self.bn(mlp_input)
        x = self.reduce_conv(x)
        context = self.context_conv(
            self.context_se(x, self.context_mlp(mlp_input)))
        depth = self.depth_se(x, self.depth_mlp(mlp_input))
        for layer in self.depth_conv:
            depth = (layer(depth, generator) if isinstance(layer, ASPP)
                     else layer(depth))
        return torch.cat([depth, context], dim=1)


class BRIAttention(nn.Module):
    """Confidence-reweighted cross-attention between two depth volumes,
    no 1/sqrt(D) scale; queries in chunks of ``chunk``."""

    def __init__(self, chunk=1024):
        super().__init__()
        self.chunk = chunk
        self.query_conv = Conv3d(1, 1, 1)
        self.key_conv = Conv3d(1, 1, 1)
        self.value_conv = Conv3d(1, 1, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, q, kv):
        b, d, h, w = q.shape
        conf = torch.softmax(q, dim=1).amax(dim=1).reshape(b, 1, h * w)

        def affine(conv, x):
            return conv.weight.reshape(()) * x + conv.bias.reshape(())

        qf = affine(self.query_conv, q).reshape(b, d, h * w)
        kf = affine(self.key_conv, kv).reshape(b, d, h * w)
        vf = affine(self.value_conv, kv).reshape(b, d, h * w) * conf
        qn = self.query_conv.q
        qt, kf, vf = qn(qf).transpose(1, 2), qn(kf), qn(vf)
        outs = []
        for start in range(0, h * w, self.chunk):
            attn = torch.softmax(torch.matmul(qt[:, start:start + self.chunk],
                                              kf), dim=-1)
            outs.append(torch.matmul(vf, qn(attn).transpose(1, 2)))
        out = torch.cat(outs, dim=-1)
        return self.gamma * out.reshape(b, d, h, w) + kv


class CA3D(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Sequential(Conv3d(c, c, 3, padding=1), nn.GELU(),
                                   GroupNorm(1, c))
        self.conv2 = nn.Sequential(Conv3d(c, c // 8, 1), nn.GELU(),
                                   Conv3d(c // 8, c, 1), nn.GELU())
        self.conv = nn.Sequential(Conv3d(c, c, 3, padding=1), nn.GELU(),
                                  GroupNorm(1, c))

    def forward(self, x):
        data = self.conv1(x)
        weight = torch.sigmoid(self.conv2(data.mean(dim=(2, 3, 4),
                                                    keepdim=True)))
        return self.conv(weight * data)


class Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn
        self.alpha = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.alpha * self.fn(x) + x


class VolumeInteraction(nn.Module):
    def __init__(self, c=32, chunk=1024):
        super().__init__()
        self.redir1 = Conv3d(2, c, 3, padding=1)
        self.dres1 = Hourglass3D(c)
        self.redir2 = Conv3d(c, 1, 3, padding=1)
        self.lss2stereo = BRIAttention(chunk)
        self.stereo2lss = BRIAttention(chunk)
        self.CA3D = Residual(CA3D(c))

    def forward(self, stereo, lss):
        lss_g = self.lss2stereo(stereo, lss)
        stereo_g = self.stereo2lss(lss, stereo)
        data = F.relu(self.redir1(torch.stack([lss_g, stereo_g], dim=1)))
        data = self.CA3D(self.dres1(data))
        return torch.softmax(F.relu(self.redir2(data))[:, 0], dim=1)


class ViewTransformer(nn.Module):
    def __init__(self, num_depth, cin, c_trans, cam, grid_shape, chunk):
        super().__init__()
        self.num_depth = num_depth
        self.c_trans = c_trans
        self.grid_shape = tuple(grid_shape)
        self.stereo_volume_net = GwcVolumeEncoder(num_depth, cin, cam=cam)
        self.depth_net = DepthNet(cin, cin, c_trans, num_depth, cam)
        self.volume_interaction = VolumeInteraction(chunk=chunk)

    def forward(self, left, right, mlp_left, mlp_right, calib, ranks,
                generator=None):
        stereo = self.stereo_volume_net(left, right, mlp_left, mlp_right,
                                        calib)
        dn = self.depth_net(left, mlp_left, generator)
        d = self.num_depth
        lss_prob = torch.softmax(dn[:, :d], dim=1)
        fused = self.volume_interaction(stereo, lss_prob)
        feat = dn[:, d:d + self.c_trans].permute(0, 2, 3, 1)
        b, _, fh, fw = fused.shape
        c = feat.shape[-1]
        x, y, z = self.grid_shape
        lifted = (fused.reshape(b, d, fh * fw, 1)
                  * feat.reshape(b, 1, fh * fw, c)).reshape(b, -1, c)
        vox = torch.stack([
            lifted.new_zeros(x * y * z + 1, c).index_add(0, ranks[i].long(),
                                                         lifted[i])[:-1]
            for i in range(b)]).view(b, x, y, z, c)
        return vox.permute(0, 4, 1, 2, 3), fused


# ------------------------------------------------------------------- bev

class BasicBlock3d(nn.Module):
    def __init__(self, cin, planes, stride, groups):
        super().__init__()
        self.conv1 = Conv3d(cin, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = GroupNorm(groups, planes)
        self.conv2 = Conv3d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = GroupNorm(groups, planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                Conv3d(cin, planes, 1, stride=stride, bias=False),
                GroupNorm(groups, planes))

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


_BLOCKS = {10: (1, 1, 1, 1), 18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class ResNet3D(nn.Module):
    def __init__(self, cin, widths, strides, depth, groups):
        super().__init__()
        self.input_proj = nn.Sequential(Conv3d(cin, widths[0], 1, bias=False),
                                        GroupNorm(groups, widths[0]),
                                        nn.ReLU())
        layers, c = [], widths[0]
        for s, (planes, stride) in enumerate(zip(widths, strides)):
            stage = []
            for i in range(_BLOCKS[depth][s]):
                stage.append(BasicBlock3d(c, planes, stride if i == 0 else 1,
                                          groups))
                c = planes
            layers.append(nn.Sequential(*stage))
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        x = self.input_proj(x)
        outs = []
        for layer in self.layers:
            x = layer(x)
            outs.append(x)
        return outs


class SECONDFPN3D(nn.Module):
    def __init__(self, in_channels, out_channels, strides, groups):
        super().__init__()
        self.deblocks = nn.ModuleList(
            nn.Sequential(ConvTranspose3d(cin, cout, s, stride=s, bias=False),
                          GroupNorm(groups, cout), nn.ReLU())
            for cin, cout, s in zip(in_channels, out_channels, strides))

    def forward(self, feats):
        return torch.cat([d(f) for d, f in zip(self.deblocks, feats)], dim=1)


class OccHead(nn.Module):
    def __init__(self, cin, classes, groups):
        super().__init__()
        self.occ_convs = nn.ModuleList([nn.Sequential(
            Conv3d(cin, cin // 2, 3, padding=1, bias=False),
            GroupNorm(groups, cin // 2), nn.ReLU(),
            Conv3d(cin // 2, classes, 1, bias=False))])

    def forward(self, x):
        return self.occ_convs[0](x)


# ------------------------------------------------------------- detector

class Detector(nn.Module):
    """The whole model, built from a configuration file's ``model`` dict
    (the fields of the program's ``DetectorConfig``)."""

    def __init__(self, m: Dict):
        super().__init__()
        self.m = m
        lo, hi, step = m["dbound"]
        self.num_depth = int(round((hi - lo) / step))
        _, _, nx = geometry.gen_dx_bx(m["xbound"], m["ybound"], m["zbound"])
        self.grid_shape = tuple(int(v) for v in nx)
        self.img_backbone = EfficientNet(m["backbone_arch"],
                                         m["backbone_out_indices"],
                                         m["backbone_drop_path_rate"])
        self.img_neck = SECONDFPN(m["neck_in_channels"],
                                  m["neck_out_channels"],
                                  m["neck_upsample_strides"])
        self.img_view_transformer = ViewTransformer(
            self.num_depth, sum(m["neck_out_channels"]), m["numC_Trans"],
            m["cam_channels"], self.grid_shape, m["attention_chunk"])
        self.img_bev_encoder_backbone = ResNet3D(
            m["numC_Trans"], m["voxel_channels"], m["voxel_strides"],
            m["resnet_depth"], m["norm_groups"])
        self.img_bev_encoder_neck = SECONDFPN3D(
            m["voxel_channels"], m["voxel_out_channels"],
            m["fpn3d_upsample_strides"], m["norm_groups"])
        self.pts_bbox_head = OccHead(sum(m["voxel_out_channels"]),
                                     m["out_channel"], m["norm_groups"])
        self.register_buffer("frustum", torch.from_numpy(
            geometry.create_frustum(tuple(m["input_size"]), m["downsample"],
                                    m["dbound"])), persistent=False)
        self.checkpoint_voxels = False

    def ranks(self, batch) -> torch.Tensor:
        """[B, D*fH*fW] voxel ranks of the left camera's frustum."""
        geom = geometry.get_geometry(
            self.frustum, batch["rots"][:, :1], batch["trans"][:, :1],
            batch["intrins"][:, :1], batch["post_rots"][:, :1],
            batch["post_trans"][:, :1], batch["bda"])[:, 0]
        m = self.m
        return geometry.voxel_ranks(geom, m["xbound"], m["ybound"],
                                    m["zbound"]).reshape(geom.shape[0], -1)

    def forward(self, batch, generator=None,
                ranks=None) -> Dict[str, torch.Tensor]:
        """batch: imgs [B, 2, H, W, 3] and the calibration tensors ->
        logits [B, classes, X, Y, Z] and depth_prob [B, D, fH, fW];
        ``ranks`` (``self.ranks(batch)``) where the caller made them."""
        imgs = batch["imgs"].float()
        b = imgs.shape[0]
        flat = imgs.transpose(0, 1).reshape((2 * b,) + imgs.shape[2:])
        feats = self.img_neck(self.img_backbone(flat.permute(0, 3, 1, 2),
                                                generator, groups=2))
        mlp = geometry.get_mlp_input(batch["rots"], batch["trans"],
                                     batch["intrins"], batch["post_rots"],
                                     batch["post_trans"], batch["bda"])
        vox, depth_prob = self.img_view_transformer(
            feats[:b], feats[b:], mlp[:, 0], mlp[:, 1], batch["calib"],
            self.ranks(batch) if ranks is None else ranks, generator)
        if self.checkpoint_voxels and torch.is_grad_enabled():
            logits = self._recomputed_voxel_side(vox)
        else:
            logits = self.pts_bbox_head(self.img_bev_encoder_neck(
                self.img_bev_encoder_backbone(vox)))
        return {"logits": logits, "depth_prob": depth_prob}

    def _recomputed_voxel_side(self, vox):
        """The voxel encoder, its neck and the head, each of the encoder's
        input projection and blocks and then the neck with the head
        recomputed in the backward (the same operations in the same order:
        the memory of a large grid, not the result, changes)."""
        enc = self.img_bev_encoder_backbone
        x = checkpoint(enc.input_proj, vox, use_reentrant=False)
        outs = []
        for layer in enc.layers:
            for block in layer:
                x = checkpoint(block, x, use_reentrant=False)
            outs.append(x)
        return checkpoint(lambda *f: self.pts_bbox_head(
            self.img_bev_encoder_neck(list(f))), *outs, use_reentrant=False)


def upsample(logits: torch.Tensor, label_shape: Sequence[int]) -> torch.Tensor:
    """Logits [B, C, X, Y, Z] -> [B, C, *label_shape], trilinear with
    half-pixel centres (the reference's final voxel upsample)."""
    return F.interpolate(logits, size=tuple(label_shape), mode="trilinear",
                         align_corners=False)


def build(model_cfg: Dict, device, quantizer: Optional[Callable] = None,
          checkpoint_blocks: bool = False) -> Detector:
    """The reference on ``device`` in float32, with every product through
    ``quantizer`` where one is given; ``checkpoint_blocks`` recomputes the
    image backbone's blocks and the voxel side in the backward."""
    with torch.device(device):
        model = Detector(model_cfg)
    model.to(device)
    if quantizer is not None:
        set_quantizer(model, quantizer)
    model.img_backbone.checkpoint_blocks = checkpoint_blocks
    model.checkpoint_voxels = checkpoint_blocks
    return model.eval()
