"""Layer building blocks of the detector.

Port of the subset of ``stereoscene_tpu/models/layers.py`` that the flagship
model runs, for inference and training. Modules compute channels-first
(NCHW / NCDHW) with the reference's ``state_dict`` keys. The JAX package's
TPU layouts (agg4d, zpack / dpack / dphase / subpixel) are layout tricks
around this same math and are not ported.

Normalisation computes in fp32 and casts back, the JAX package's fp32
islands (``layers.py`` GroupNorm / BatchNorm defaults), so a bf16 model
keeps fp32 statistics.

Randomness (DropPath, Dropout) comes from an optional ``torch.Generator``
through ``keep_mask``, so a caller can seed it; the JAX package draws from
its ``dropout`` rng stream, which gives other bits from the same seed.

Data parallelism (``parallel``): in training, BatchNorm takes the global
batch's statistics and ``keep_mask`` draws for the global batch, as the
JAX package's one step over the sharded global batch does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import parallel
from ..ops.conv3d import KERNEL_CIN, conv3d_s1


def ConvTransposeTorch(cin: int, cout: int, kernel_size: int, ndim: int,
                       stride: int = 1, padding: int = 0,
                       output_padding: int = 0, bias: bool = False):
    """Torch transposed convolution (k3 s2 p1 op1 in the hourglasses,
    k = s in the FPN necks)."""
    cls = nn.ConvTranspose2d if ndim == 2 else nn.ConvTranspose3d
    return cls(cin, cout, kernel_size, stride=stride, padding=padding,
               output_padding=output_padding, bias=bias)


def keep_mask(shape, keep: float, generator, device,
              groups: int = 1) -> torch.Tensor:
    """Bernoulli(``keep``) bool mask of ``shape`` on ``device``, drawn from
    ``generator`` (on the generator's device; torch's default generator
    when None).

    ``shape[0]`` is ``groups`` blocks of this rank's batch (the image
    backbone stacks the left eyes, then the right ones). Over W ranks the
    draw is for the global batch, each block W times as long, and this
    rank keeps its slice of each block: W ranks that share the generator's
    seed then draw what one process draws at W times the batch."""
    gen_device = generator.device if generator is not None else device
    w, r = parallel.world_size(), parallel.rank()
    n = shape[0] // groups
    draw = torch.rand((groups, w * n) + tuple(shape[1:]),
                      generator=generator, device=gen_device)
    draw = draw[:, r * n:(r + 1) * n].reshape(shape)
    return (draw < keep).to(device)


def dropout(x: torch.Tensor, rate: float, generator=None,
            mask=None) -> torch.Tensor:
    """Element-wise dropout, flax ``nn.Dropout``: kept values scaled by
    1 / (1 - rate). ``mask`` (a ``keep_mask`` of ``x.shape`` drawn
    earlier) replaces the draw from ``generator``."""
    keep = 1.0 - rate
    if mask is None:
        mask = keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drop_path(x: torch.Tensor, keep: torch.Tensor,
              rate: float) -> torch.Tensor:
    """Per-sample stochastic depth (layers.py:1039-1052): sample n of ``x``
    is zeroed where ``keep[n]`` is False and scaled by 1 / (1 - rate)
    where it is True."""
    mask = keep.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class GroupNorm(nn.GroupNorm):
    """GroupNorm (eps 1e-5) computed in fp32.

    The statistics come from ``torch.var_mean`` over each (sample, group)
    row rather than ``F.group_norm``: on CUDA the latter reduces each row in
    one thread block, so the GN(2) layers of the cost-volume hourglasses
    (2 rows of 13.7M elements at the flagship) ran on 2 of the card's SMs."""

    def forward(self, x):
        b, c = x.shape[:2]
        rows = x.float().reshape(b, self.num_groups, -1)
        var, mean = torch.var_mean(rows, dim=-1, correction=0, keepdim=True)
        y = ((rows - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        affine = (1, c) + (1,) * (x.dim() - 2)
        return (y * self.weight.float().reshape(affine)
                + self.bias.float().reshape(affine)).to(x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm on any channels-first rank, computed in fp32.

    Eval mode normalises with the running statistics and runs no
    collective. Training mode normalises with the batch's mean and biased
    variance and updates the running statistics as flax does
    (layers.py:958-976): r <- (1 - m) r + m * batch statistic with m =
    ``self.momentum`` (torch's convention) and the *biased* variance, where
    ``F.batch_norm`` would take the unbiased one. ``stats_frozen``
    (set by ``checkpoint_region``) leaves them alone: the recompute of a
    checkpointed block must not update them a second time.

    In a process group the batch is the global one, every rank's: the
    statistics are pooled by ``parallel.all_sum`` in two passes, (count,
    sum) for the mean, then the centred sum of squares, never as E[x^2] -
    E[x]^2. Every rank then normalises with, and updates its running
    statistics to, the same values. A checkpointed block's recompute pools
    again, on every rank in the same order."""

    stats_frozen = False

    def forward(self, x):
        xf = x.float()
        if not self.training:
            return F.batch_norm(
                xf, self.running_mean.float(), self.running_var.float(),
                self.weight.float(), self.bias.float(), False, 0.0,
                self.eps).to(x.dtype)
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if parallel.initialized():
            count = xf.numel() // xf.shape[1]
            sums = parallel.all_sum(torch.cat([xf.sum(dims),
                                               xf.new_full((1,), count)]))
            mean = sums[:-1] / sums[-1]
            var = parallel.all_sum(
                (xf - mean.reshape(shape)).square().sum(dims)) / sums[-1]
        else:
            var, mean = torch.var_mean(xf, dim=dims, correction=0)
        if not self.stats_frozen:
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                     + self.eps)
        return (y * self.weight.float().reshape(shape)
                + self.bias.float().reshape(shape)).to(x.dtype)


def checkpoint_region(module: nn.Module, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint(use_reentrant=False)``
    (the JAX package's ``nn.remat``): the forward updates the BatchNorm
    statistics of ``module`` once, and its recompute in the backward runs
    with them frozen. Randomness must be drawn before the region and passed
    in, as the recompute would draw again from an explicit generator."""
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
        for m in norms:
            m.stats_frozen = True
        try:
            return fn(*a)
        finally:
            for m in norms:
                m.stats_frozen = False

    return checkpoint(run, *args, use_reentrant=False)


def remat(on: bool, module: nn.Module, *args):
    """``module(*args)``, through ``checkpoint_region`` where ``on`` and
    the module trains under grad."""
    if on and module.training and torch.is_grad_enabled():
        return checkpoint_region(module, module, *args)
    return module(*args)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` (same ``weight`` / ``bias`` keys) that sends a conv to
    kernel K4 (``ops.conv3d.conv3d_s1``) under the JAX package's gate
    (``ConvNd``, layers.py:644-661): 3x3x3, stride 1, padding 1, groups 1,
    Ci in {64, 128}, Co >= 64, a 5-D input, and built with
    ``kernel=True`` (the port's ``STEREOSCENE_PALLAS_CONV3D=1``). Any other
    conv is ``F.conv3d``. The bias is added outside the kernel, as the JAX
    package's ``_PallasConv3d`` does."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1,
                 padding=0, bias: bool = True, kernel: bool = False):
        super().__init__(cin, cout, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.k4 = kernel and (
            self.kernel_size == (3, 3, 3) and self.stride == (1, 1, 1)
            and self.padding == (1, 1, 1) and self.dilation == (1, 1, 1)
            and self.groups == 1 and self.padding_mode == "zeros"
            and cin in KERNEL_CIN and cout >= 64)

    def forward(self, x):
        if not (self.k4 and x.dim() == 5):
            return super().forward(x)
        y = conv3d_s1(x, self.weight)
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype).reshape(1, -1, 1, 1, 1)


def ConvGN3d(cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
             padding: int = 1, num_groups: int = 2,
             conv3d_kernel: bool = False) -> nn.Sequential:
    """conv3d (no bias) + GroupNorm: the reference's ``convbn_3d``
    (ViewTransformerLSSVoxel.py:66-69), keys ``.0`` conv and ``.1`` norm."""
    return nn.Sequential(
        Conv3d(cin, cout, kernel_size, stride=stride, padding=padding,
               bias=False, kernel=conv3d_kernel),
        GroupNorm(num_groups, cout))


class Mlp(nn.Module):
    """fc1 -> ReLU -> fc2 (ref: ViewTransformerLSSBEVDepth.py:417-439)."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, cout)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    """Camera-aware SE: gate x [B, C, H, W] by sigmoid(expand(relu(
    reduce(x_se)))) with x_se [B, C] (ref: ViewTransformerLSSBEVDepth.py
    :442-454; both 1x1 convs at full width)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, channels, 1)
        self.conv_expand = nn.Conv2d(channels, channels, 1)

    def forward(self, x, x_se):
        s = F.relu(self.conv_reduce(x_se[:, :, None, None]))
        return x * torch.sigmoid(self.conv_expand(s))
