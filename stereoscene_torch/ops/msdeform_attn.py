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

The JAX package computes both with XLA gathers, not a Pallas kernel, and
the plain route here (``_msdeform``) is the same gathers in torch: the CPU
route, and the 2D ``msdeform_attn`` on every device. On CUDA tensors
``msdeform_attn_3d`` launches one hand-written kernel a call,
``csrc/msdeform.cu`` (``stereoscene_msdeform3d``), which gathers the 8
corners, weighs them and sums every level and point in fp32 in one pass,
forward only. Each ``msdeform_attn_3d`` call opens the span
``stereoscene.msdeform`` while a profiler runs (``utils.spans``), and the
kernel's launch opens ``stereoscene.msdeform.kernel`` inside it.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import torch

from .. import _build
from ..utils.spans import span
from ._dispatch import want_kernel

# the levels the kernel's table holds (csrc/msdeform.cu kMaxLevels)
KERNEL_LEVELS = 4


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


def level_table(spatial_shapes: Sequence[Tuple[int, int, int]]
                ) -> Tuple[Tuple[int, ...], int]:
    """The kernel's level table from the static (X, Y, Z) of each level:
    (X, Y, Z, first row) level after level, zeros past the last level up to
    ``KERNEL_LEVELS``, and the rows of all levels. The rows of a level
    are flattened X-outermost (``_geometry_3d``'s strides Y * Z, Z, 1),
    one level after another, as ``_msdeform`` walks them."""
    if not 1 <= len(spatial_shapes) <= KERNEL_LEVELS:
        raise ValueError(f"msdeform_attn_3d kernel: {len(spatial_shapes)} "
                         f"levels, it takes 1 to {KERNEL_LEVELS}")
    table, rows = [], 0
    for shape in spatial_shapes:
        x, y, z = (int(s) for s in shape)
        table += [x, y, z, rows]
        rows += x * y * z
    table += [0] * (4 * (KERNEL_LEVELS - len(spatial_shapes)))
    return tuple(table), rows


def msdeform_attn_3d_kernel(value: torch.Tensor,
                            spatial_shapes: Sequence[Tuple[int, int, int]],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Launch ``csrc/msdeform.cu`` on CUDA tensors or raise: value
    [B, N, C] fp32 or bf16, sampling_locations [B, Q, heads, L, P, 3] fp32,
    attention_weights [B, Q, heads, L, P] in the values' dtype, L at most
    ``KERNEL_LEVELS`` -> [B, Q, C] in the values' dtype."""
    if value.dtype not in (torch.float32, torch.bfloat16) \
            or attention_weights.dtype != value.dtype \
            or sampling_locations.dtype != torch.float32:
        raise TypeError(
            f"msdeform_attn_3d kernel takes fp32 or bf16 values, weights in "
            f"their dtype and fp32 locations, got {value.dtype}, "
            f"{attention_weights.dtype} and {sampling_locations.dtype}")
    table, rows = level_table(spatial_shapes)
    b, n, c = value.shape
    _, q, heads, levels, points, nd = sampling_locations.shape
    if heads != num_heads or c % heads or nd != 3 or n != rows \
            or levels != len(spatial_shapes) \
            or sampling_locations.shape[0] != b \
            or attention_weights.shape != sampling_locations.shape[:-1]:
        raise ValueError(
            f"msdeform_attn_3d kernel: value {tuple(value.shape)}, "
            f"locations {tuple(sampling_locations.shape)}, weights "
            f"{tuple(attention_weights.shape)} for {num_heads} heads and "
            f"levels {list(spatial_shapes)} ({rows} rows)")
    device = value.get_device()
    if device < 0 or sampling_locations.get_device() != device \
            or attention_weights.get_device() != device:
        raise ValueError("msdeform_attn_3d kernel: the inputs must be on "
                         "one card")
    out = value.new_empty((b, q, c))
    if out.numel() == 0:
        return out
    value = value.contiguous()
    sampling_locations = sampling_locations.contiguous()
    attention_weights = attention_weights.contiguous()
    with span("stereoscene.msdeform.kernel"):
        _build.launch("msdeform_attn_3d", device, value.data_ptr(),
                      sampling_locations.data_ptr(),
                      attention_weights.data_ptr(), out.data_ptr(), b, n, q,
                      heads, c // heads, levels, points,
                      int(value.dtype == torch.bfloat16), *table)
    return out


def msdeform_attn_3d(value: torch.Tensor,
                     spatial_shapes: Sequence[Tuple[int, int, int]],
                     sampling_locations: torch.Tensor,
                     attention_weights: torch.Tensor,
                     num_heads: int, use_kernel=None) -> torch.Tensor:
    """Trilinear variant: value [B, sum(X*Y*Z), C] (each level flattened
    with X outermost); spatial_shapes the (X, Y, Z) of each level;
    sampling_locations [B, Q, heads, levels, P, 3] as (x, y, z) in [0, 1].
    Returns [B, Q, C].

    On CUDA tensors (``use_kernel`` None or True) this launches
    ``msdeform_attn_3d_kernel`` or raises; it has no backward, so an input
    that requires grad under grad mode raises there. On CPU tensors, or with
    ``use_kernel`` False, it runs the plain gathers."""
    with span("stereoscene.msdeform"):
        if want_kernel("msdeform_attn_3d", use_kernel, value,
                       sampling_locations, attention_weights):
            return msdeform_attn_3d_kernel(value, spatial_shapes,
                                           sampling_locations,
                                           attention_weights, num_heads)
        return _msdeform(value, spatial_shapes, sampling_locations,
                         attention_weights, num_heads, _geometry_3d)
