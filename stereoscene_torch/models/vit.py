"""ViT image backbone with a 4-scale output pyramid, port of
``stereoscene_tpu/models/vit.py`` (ref: the reference's models/backbones/
vit.py with the SimpleFPN pattern of bevformer/modules/simplefpn.py).

Patchify, pre-norm transformer blocks (flax's ``MultiHeadDotProductAttention``
math: per-head query / key / value projections, softmax(q k^T / sqrt(d))
in fp32, an output projection; exact-erf GELU; LayerNorms in fp32 with
eps 1e-6), a final LayerNorm, then the 1/patch token map resampled to each
of ``out_strides`` by a k = s transposed conv (finer), identity, or an
average pool (coarser). Images are channels-first [N, 3, H, W]; the
learned position table is sized for ``img_size``. Keys follow the JAX
module paths, flax's automatic ``LayerNorm_0`` / ``LayerNorm_1`` names
included.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .bevformer import LayerNorm32


class Attention(nn.Module):
    """Multi-head attention, flax ``MultiHeadDotProductAttention`` with
    ``qkv_features == dim``: per-head query / key / value projections
    (flax DenseGeneral [dim, heads, dh] plus bias, held as Linear layers)
    and the ``out`` projection from [heads, dh]. ``inputs_k`` defaults to
    ``inputs_q`` and ``inputs_v`` to ``inputs_k``, as in flax."""

    dense_general = {"query": "in", "key": "in", "value": "in", "out": "out"}

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, inputs_q, inputs_k=None, inputs_v=None):
        inputs_k = inputs_q if inputs_k is None else inputs_k
        inputs_v = inputs_k if inputs_v is None else inputs_v
        b, n, d = inputs_q.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(b, -1, h, d // h).transpose(1, 2)

        q = heads(self.query(inputs_q)) / math.sqrt(d // h)
        k, v = heads(self.key(inputs_k)), heads(self.value(inputs_v))
        attn = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1)
        y = attn.to(v.dtype) @ v
        return self.out(y.transpose(1, 2).reshape(b, n, d))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.LayerNorm_0 = LayerNorm32(dim)
        self.attn = Attention(dim, num_heads)
        self.LayerNorm_1 = LayerNorm32(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x + self.attn(self.LayerNorm_0(x))
        y = F.gelu(self.mlp_fc1(self.LayerNorm_1(x)))
        return x + self.mlp_fc2(y)


class ViT(nn.Module):
    """Columnar ViT; [N, 3, H, W] -> one map per ``out_strides`` entry."""

    def __init__(self, img_size: Tuple[int, int], patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 out_strides: Tuple[int, ...] = (4, 8, 16, 32),
                 in_channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.depth = depth
        self.out_strides = tuple(out_strides)
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch_size,
                                     stride=patch_size)
        n = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        self.pos_embed = nn.Parameter(torch.randn(1, n, embed_dim) * 0.02)
        for i in range(depth):
            setattr(self, f"block{i}", TransformerBlock(embed_dim, num_heads))
        self.LayerNorm_0 = LayerNorm32(embed_dim)
        for stride in self.out_strides:
            factor = patch_size // stride
            if factor > 1:
                setattr(self, f"up{stride}", nn.ConvTranspose2d(
                    embed_dim, embed_dim, factor, stride=factor))

    def forward(self, x):
        tokens = self.patch_embed(x)
        b, d, fh, fw = tokens.shape
        tokens = tokens.flatten(2).transpose(1, 2) + self.pos_embed.to(
            tokens.dtype)
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        feat = self.LayerNorm_0(tokens).transpose(1, 2).reshape(b, d, fh, fw)
        outs = []
        for stride in self.out_strides:
            factor = self.patch_size // stride
            if factor > 1:
                outs.append(getattr(self, f"up{stride}")(feat))
            elif factor == 1:
                outs.append(feat)
            else:
                k = stride // self.patch_size
                outs.append(F.avg_pool2d(feat, k, stride=k))
        return tuple(outs)
