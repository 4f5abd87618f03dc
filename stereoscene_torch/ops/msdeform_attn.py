"""Multi-scale deformable attention as plain gathers, port of
``stereoscene_tpu/ops/msdeform_attn.py`` (ref: bevformer/modules/
multi_scale_deformable_attn_function.py, the CUDA MSDeformAttn that the
BEVFormer / BEVOcc encoders and the occupancy pixel decoder call).

Each query samples every value level at P learned locations and sums the
samples under its attention weights. The JAX package's convention is kept
exactly: a location in [0, 1] maps to the pixel coordinate
``loc * size - 0.5`` (align_corners=False), the 2^nd corners around it
(four in 2D, eight in 3D) take the multilinear weights, and a corner
outside the level contributes zero. The corners and the attention weights
are folded into one weight per gathered row, so a level costs one gather
and one batched matrix-vector product. The weights are fp32 and are cast
to the values' dtype before the product, as the JAX package multiplies its
values by fp32 weights.

This is plain torch on every device: the JAX package computes it with XLA
gathers, not a Pallas kernel. Each ``msdeform_attn_3d`` call opens the span
``stereoscene.msdeform`` while a profiler runs (``utils.spans``).
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch

from ..utils.spans import span


def _sample_level(flat: torch.Tensor, loc: torch.Tensor, attn: torch.Tensor,
                  sizes: Sequence[int], strides: Sequence[int]) -> torch.Tensor:
    """Attention-weighted multilinear samples of one level.

    flat: [B * heads, N, c] values of the level; loc: [B, Q, heads, P, nd]
    in [0, 1], component i along a level axis of ``sizes[i]`` cells whose
    flat index stride is ``strides[i]``; attn: [B, Q, heads, P].
    Returns [B, Q, heads, c]."""
    b, q, heads, p, nd = loc.shape
    c = flat.shape[-1]
    dev = loc.device
    size = torch.tensor(sizes, dtype=torch.float32, device=dev)
    hi = torch.tensor(sizes, dtype=torch.long, device=dev) - 1
    stride = torch.tensor(strides, dtype=torch.long, device=dev)
    pos = loc.float() * size - 0.5
    base = torch.floor(pos)
    frac = pos - base
    base = base.long()
    idx, wgt = [], []
    for corner in itertools.product((0, 1), repeat=nd):
        off = torch.tensor(corner, dtype=torch.long, device=dev)
        cell = base + off
        inside = ((cell >= 0) & (cell <= hi)).all(dim=-1)
        cell = torch.minimum(cell.clamp_min(0), hi)
        idx.append((cell * stride).sum(dim=-1))
        w = torch.where(off.bool(), frac, 1.0 - frac).prod(dim=-1)
        wgt.append(w * inside)
    k = len(idx)
    idx = torch.stack(idx, dim=-1).permute(0, 2, 1, 3, 4).reshape(
        b * heads, q * p * k)
    wgt = (torch.stack(wgt, dim=-1) * attn.float()[..., None]).permute(
        0, 2, 1, 3, 4).reshape(b * heads * q, 1, p * k)
    rows = flat.gather(1, idx[..., None].expand(-1, -1, c))
    out = torch.bmm(wgt.to(flat.dtype), rows.reshape(b * heads * q, p * k, c))
    return out.reshape(b, heads, q, c).permute(0, 2, 1, 3)


def _msdeform(value, shapes, locs, weights, num_heads, geometry):
    b, _, c = value.shape
    ch = c // num_heads
    q = locs.shape[1]
    out = None
    offset = 0
    for lvl, shape in enumerate(shapes):
        n = 1
        for s in shape:
            n *= int(s)
        v = value[:, offset:offset + n].reshape(b, n, num_heads, ch)
        offset += n
        flat = v.permute(0, 2, 1, 3).reshape(b * num_heads, n, ch)
        sizes, strides = geometry(shape)
        y = _sample_level(flat, locs[:, :, :, lvl], weights[:, :, :, lvl],
                          sizes, strides)
        out = y if out is None else out + y
    return out.reshape(b, q, num_heads * ch)


def _geometry_2d(shape):
    h, w = (int(s) for s in shape)
    return (w, h), (1, w)  # loc (x, y): x along W, y along H


def _geometry_3d(shape):
    x, y, z = (int(s) for s in shape)
    return (x, y, z), (y * z, z, 1)


def msdeform_attn(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """value [B, sum(H*W), C] (levels flattened row-major); spatial_shapes
    the static (H, W) of each level; sampling_locations [B, Q, heads,
    levels, P, 2] as (x, y) in [0, 1]; attention_weights [B, Q, heads,
    levels, P] (already softmaxed). Returns [B, Q, C]."""
    return _msdeform(value, spatial_shapes, sampling_locations,
                     attention_weights, num_heads, _geometry_2d)


def msdeform_attn_3d(value: torch.Tensor,
                     spatial_shapes: Sequence[Tuple[int, int, int]],
                     sampling_locations: torch.Tensor,
                     attention_weights: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Trilinear variant: value [B, sum(X*Y*Z), C] (each level flattened
    with X outermost); spatial_shapes the (X, Y, Z) of each level;
    sampling_locations [B, Q, heads, levels, P, 3] as (x, y, z) in [0, 1].
    Returns [B, Q, C]."""
    with span("stereoscene.msdeform"):
        return _msdeform(value, spatial_shapes, sampling_locations,
                         attention_weights, num_heads, _geometry_3d)
