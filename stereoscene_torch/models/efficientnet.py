"""EfficientNet image backbone (b0-b8 and the EdgeTPU es / em / el), port
of ``stereoscene_tpu/models/efficientnet.py``.

Compound width/depth scaling of the base layer table, TF-SAME adaptive
padding, BN(eps 1e-3) + Swish, squeeze-excite on the expanded width, and
multi-stage outputs by ``out_indices`` (0 = stem, 1..5 = block stages,
6 = head conv). Keys follow the reference (mmcls ``CustomEfficientNet``:
``layers.0`` stem, ``layers.1..5`` stages, ``layers.6`` head).

Training mode adds stochastic depth, its rate rising linearly over the
blocks to ``drop_path_rate`` (efficientnet.py:453-457 of the JAX package),
and with ``with_cp`` checkpoints each block with
``torch.utils.checkpoint(use_reentrant=False)`` (the JAX package's
``nn.remat``). The DropPath masks are drawn before a checkpointed block, so
its recompute sees the same mask, and the recompute does not update the
BatchNorm statistics a second time.

Inference on a card replays one captured CUDA graph of the backbone's
body in place of launching its ~2,300 small operations one by one
(``CustomEfficientNet.forward``). The replay runs the kernels eager mode
launches, the fp32 BatchNorm islands included.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.spans import span
from .layers import BatchNorm, checkpoint_region, drop_path, keep_mask

# Base (b0) table per stage: (kernel, out_channels, se_ratio, stride,
# expand_ratio) (ref: efficientnet.py:308-327 layer_settings['b']).
_BASE_BLOCKS = [
    [(3, 16, 4, 1, 1)],
    [(3, 24, 4, 2, 6), (3, 24, 4, 1, 6)],
    [(5, 40, 4, 2, 6), (5, 40, 4, 1, 6)],
    [(3, 80, 4, 2, 6), (3, 80, 4, 1, 6), (3, 80, 4, 1, 6),
     (5, 112, 4, 1, 6), (5, 112, 4, 1, 6), (5, 112, 4, 1, 6)],
    [(5, 192, 4, 2, 6), (5, 192, 4, 1, 6), (5, 192, 4, 1, 6),
     (5, 192, 4, 1, 6), (3, 320, 4, 1, 6)],
]
_STEM = (3, 32, 2)  # kernel, channels, stride
_HEAD = (1, 1280, 1)

# EfficientNet-EdgeTPU ('e') table (ref: efficientnet.py:328-347
# layer_settings['e']): no SE; the 6th element is the block type, 1 =
# EdgeResidual (the 3x3 24/32/48 stages), 0 = InvertedResidual (the 5x5
# 96/144/192 stages).
_BASE_BLOCKS_E = [
    [(3, 24, 0, 1, 3, 1)],
    [(3, 32, 0, 2, 8, 1), (3, 32, 0, 1, 8, 1)],
    [(3, 48, 0, 2, 8, 1), (3, 48, 0, 1, 8, 1), (3, 48, 0, 1, 8, 1),
     (3, 48, 0, 1, 8, 1)],
    [(5, 96, 0, 2, 8, 0), (5, 96, 0, 1, 8, 0), (5, 96, 0, 1, 8, 0),
     (5, 96, 0, 1, 8, 0), (5, 96, 0, 1, 8, 0),
     (5, 144, 0, 1, 8, 0), (5, 144, 0, 1, 8, 0), (5, 144, 0, 1, 8, 0),
     (5, 144, 0, 1, 8, 0)],
    [(5, 192, 0, 2, 8, 0), (5, 192, 0, 1, 8, 0)],
]

# (width_mult, depth_mult) (ref: efficientnet.py:354-367)
ARCH_SETTINGS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
    "b8": (2.2, 3.6), "es": (1.0, 1.0), "em": (1.0, 1.1), "el": (1.2, 1.4),
}


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def scaled_stage_settings(arch: str):
    """(stem_channels, stages, head_channels) after compound scaling; a
    segment of equal-width blocks is repeated ceil(d * len) times and a
    stride-1-leading segment joins the previous stage
    (ref: efficientnet.py:231-271 model_scaling). A block is (kernel,
    out_channels, se_ratio, stride, expand) in the 'b' family and (kernel,
    out_channels, se_ratio, stride, expand, kind, with_residual) in the
    EdgeTPU family, kind 'edge' (``EdgeResidual``) or 'mb'
    (``InvertedResidual``); a depth-scaled copy of the expand-3 edge block
    takes expand 4 and no residual (ref: efficientnet.py:474-478)."""
    if arch not in ARCH_SETTINGS:
        raise ValueError(f"unsupported EfficientNet arch {arch!r}")
    w, d = ARCH_SETTINGS[arch]
    edge = arch[0] == "e"
    segments = []
    for group in _BASE_BLOCKS_E if edge else _BASE_BLOCKS:
        current = []
        for blk in group:
            k, c, se, s, e = blk[:5]
            c = make_divisible(c * w, 8)
            if current and current[-1][1] != c:
                segments.append(current)
                current = []
            current.append((k, c, se, s, e) + tuple(blk[5:]))
        segments.append(current)
    stages = []
    for i, seg in enumerate(segments):
        n = int(math.ceil(d * len(seg)))
        blocks = seg[:n] if n <= len(seg) else seg + [seg[-1]] * (n - len(seg))
        if i > 0 and blocks[0][3] == 1:
            stages[-1] = stages[-1] + blocks
        else:
            stages.append(list(blocks))
    if edge:
        stages = [[(k, c, se, s,
                    4 if (bt == 1 and j > 0 and e == 3) else e,
                    "edge" if bt == 1 else "mb",
                    not (bt == 1 and j > 0 and e == 3))
                   for j, (k, c, se, s, e, bt) in enumerate(stage)]
                  for stage in stages]
    return (make_divisible(_STEM[1] * w, 8), stages, int(_HEAD[1] * w))


class Conv2dSamePad(nn.Conv2d):
    """TF-SAME adaptive padding (mmcv Conv2dAdaptivePadding)."""

    def forward(self, x):
        ih, iw = x.shape[-2:]
        kh, kw = self.weight.shape[-2:]
        sh, sw = self.stride
        ph = max((math.ceil(ih / sh) - 1) * sh + kh - ih, 0)
        pw = max((math.ceil(iw / sw) - 1) * sw + kw - iw, 0)
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


class ConvBNAct(nn.Module):
    """mmcv ConvModule: ``.conv`` (TF-SAME, no bias) + ``.bn`` (eps 1e-3)
    + Swish."""

    def __init__(self, cin, cout, k, stride=1, groups=1, act=True):
        super().__init__()
        self.conv = Conv2dSamePad(cin, cout, k, stride=stride, groups=groups,
                                  bias=False)
        self.bn = BatchNorm(cout, eps=1e-3)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class EffSELayer(nn.Module):
    """Self squeeze-excite: ``conv1.conv`` / ``conv2.conv`` 1x1 with Swish /
    sigmoid (mmdet SELayer); the pool is fp32."""

    def __init__(self, channels, squeeze):
        super().__init__()
        self.conv1 = nn.Module()
        self.conv1.conv = nn.Conv2d(channels, squeeze, 1)
        self.conv2 = nn.Module()
        self.conv2.conv = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x):
        s = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        s = F.silu(self.conv1.conv(s))
        return x * torch.sigmoid(self.conv2.conv(s))


class InvertedResidual(nn.Module):
    """MBConv block (ref: efficientnet.py:112-229). ``forward(x, keep)``
    takes the block's DropPath mask [N] (None: no drop)."""

    def __init__(self, cin, cout, kernel, stride, expand_ratio, se_ratio,
                 drop_path_rate=0.0, with_cp=False):
        super().__init__()
        mid = cin * expand_ratio
        self.with_res = stride == 1 and cin == cout
        self.drop_path_rate = drop_path_rate
        self.with_cp = with_cp
        self.expand_conv = ConvBNAct(cin, mid, 1) if mid != cin else None
        self.depthwise_conv = ConvBNAct(mid, mid, kernel, stride=stride,
                                        groups=mid)
        self.se = (EffSELayer(mid, max(1, int(mid // (expand_ratio
                                                      * se_ratio))))
                   if se_ratio > 0 else None)
        self.linear_conv = ConvBNAct(mid, cout, 1, act=False)

    def forward(self, x, keep=None):
        if not (self.with_cp and self.training and torch.is_grad_enabled()):
            return self._block(x, keep)
        return checkpoint_region(self, self._block, x, keep)

    def _block(self, x, keep):
        out = x if self.expand_conv is None else self.expand_conv(x)
        out = self.depthwise_conv(out)
        if self.se is not None:
            out = self.se(out)
        out = self.linear_conv(out)
        if not self.with_res:
            return out
        if keep is not None:
            out = drop_path(out, keep, self.drop_path_rate)
        return x + out

    def drop_mask(self, x, generator, groups: int = 1):
        """This block's DropPath mask for input ``x``, or None where it
        drops nothing (eval mode, rate 0, no residual); ``groups`` as
        ``layers.keep_mask`` takes it."""
        if not (self.training and self.with_res and self.drop_path_rate > 0):
            return None
        return keep_mask((x.shape[0],), 1.0 - self.drop_path_rate,
                         generator, x.device, groups)


class EdgeResidual(InvertedResidual):
    """EdgeTPU block (ref: efficientnet.py:15-111): a full-kernel expand
    conv ``conv1`` at stride 1, optional SE, a strided 1x1 projection
    ``conv2``; the residual where ``with_residual``, stride 1 and equal
    widths. Checkpointing and DropPath as ``InvertedResidual``."""

    def __init__(self, cin, cout, kernel, stride, expand_ratio, se_ratio,
                 drop_path_rate=0.0, with_cp=False, with_residual=True):
        nn.Module.__init__(self)
        mid = cin * expand_ratio
        self.with_res = with_residual and stride == 1 and cin == cout
        self.drop_path_rate = drop_path_rate
        self.with_cp = with_cp
        self.conv1 = ConvBNAct(cin, mid, kernel)
        self.se = (EffSELayer(mid, max(1, int(mid // (expand_ratio
                                                      * se_ratio))))
                   if se_ratio > 0 else None)
        self.conv2 = ConvBNAct(mid, cout, 1, stride=stride, act=False)

    def _block(self, x, keep):
        out = self.conv1(x)
        if self.se is not None:
            out = self.se(out)
        out = self.conv2(out)
        if not self.with_res:
            return out
        if keep is not None:
            out = drop_path(out, keep, self.drop_path_rate)
        return x + out


class CudaGraphs:
    """How ``CustomEfficientNet`` captures its eval body: a CUDA graph of
    the current card, captured on a side stream into a private memory pool.
    Tests put a stand-in with the same two methods in its place
    (``GRAPHS``)."""

    @staticmethod
    def accepts(x: torch.Tensor) -> bool:
        """True where ``x`` is on a card whose stream is not capturing."""
        return x.is_cuda and not torch.cuda.is_current_stream_capturing()

    @staticmethod
    def capture(body):
        """(graph, outputs) of ``body()`` captured without running it: the
        outputs hold its results after each ``graph.replay()``. Only this
        thread is barred from unsafe CUDA calls during the capture, so a
        loader's threads may go on copying."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = body()
        return graph, out


GRAPHS = CudaGraphs


class CustomEfficientNet(nn.Module):
    """Multi-output EfficientNet; [N, 3, H, W] -> list of feature maps."""

    def __init__(self, arch: str = "b0", out_indices: Sequence[int] = (6,),
                 drop_path_rate: float = 0.0, with_cp: bool = False):
        super().__init__()
        stem_ch, stages, head_ch = scaled_stage_settings(arch)
        self.out_indices = tuple(out_indices)
        total = sum(len(s) for s in stages)
        rates = iter(drop_path_rate * i / max(total - 1, 1)
                     for i in range(total))
        layers = [ConvBNAct(3, stem_ch, _STEM[0], stride=_STEM[2])]
        cin = stem_ch
        for stage in stages:
            blocks = []
            for blk in stage:
                k, c, se, s, e = blk[:5]
                if len(blk) == 7 and blk[5] == "edge":
                    blocks.append(EdgeResidual(cin, c, k, s, e, se,
                                               next(rates), with_cp, blk[6]))
                else:
                    blocks.append(InvertedResidual(cin, c, k, s, e, se,
                                                   next(rates), with_cp))
                cin = c
            layers.append(nn.Sequential(*blocks))
        layers.append(ConvBNAct(cin, head_ch, _HEAD[0], stride=_HEAD[2]))
        self.layers = nn.ModuleList(layers)
        # the input key (shape, strides, dtype, device) last run, and once
        # captured for it (graph, static input, static outputs)
        self._graph_key = self._graph = None

    def forward(self, x, generator=None, groups: int = 1):
        """``generator`` seeds the DropPath masks in training mode; ``x``
        stacks ``groups`` blocks of the batch (``layers.keep_mask``).

        Inference on a card (eval mode, no autograd, a stream that is not
        already capturing) runs eagerly on the first call with an input
        key (shape, strides, dtype, device), which warms up cuDNN and the
        allocator; the second captures the body into a CUDA graph over a
        static input buffer, and from then on each call copies ``x`` in and
        replays the graph. A new key drops the graph, as does ``_apply``
        (``.to``, ``.cuda``, ``.half``); ``load_state_dict`` copies in
        place, so the graph reads the new weights. The returned maps then
        live in the graph's pool and the next call overwrites them: use them
        before calling again, as ``encode_images`` does, handing them
        straight to the neck. Training, eval under autograd and the CPU
        run the body eagerly."""
        if self.training or torch.is_grad_enabled() or not GRAPHS.accepts(x):
            return self._forward(x, generator, groups)
        key = (x.shape, x.stride(), x.dtype, x.device)
        if key != self._graph_key:
            self._graph_key, self._graph = key, None
            return self._forward(x, generator, groups)
        if self._graph is None:
            with span("stereoscene.images.capture"):
                static_in = torch.empty_like(x)
                graph, out = GRAPHS.capture(lambda: self._forward(static_in))
            self._graph = graph, static_in, out
        graph, static_in, out = self._graph
        with span("stereoscene.images.replay"):
            static_in.copy_(x)
            graph.replay()
        return list(out)

    def _apply(self, *args, **kwargs):
        # a graph reads the storage the parameters had when it was captured
        self._graph_key = self._graph = None
        return super()._apply(*args, **kwargs)

    def _forward(self, x, generator=None, groups: int = 1):
        outs = []
        last = max(self.out_indices)
        for i, layer in enumerate(self.layers):
            if i > last:
                break
            if isinstance(layer, nn.Sequential):  # a stage of blocks
                for block in layer:
                    x = block(x, block.drop_mask(x, generator, groups))
            else:
                x = layer(x)
            if i in self.out_indices:
                outs.append(x)
        return outs
