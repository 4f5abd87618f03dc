"""Voxel pooling (the LSS splat) over a static sorted plan.

Port of ``stereoscene_tpu/ops/voxel_pool.py`` (``lift_splat_static``) with
the Pallas splats ``ops/pallas_splat.py`` (K2) and
``ops/pallas_splat_fused.py`` (K3) as one CUDA kernel, ``csrc/splat.cu``,
with two entry points:

- ``lift_splat_fused``: the lift inside the reduction (K3), the production
  splat of the main path;
- ``splat_sorted``: a segment sum of pre-lifted rank-sorted rows (K2).

Plans come from ``ops/splat_plan.py``. The kernel balances its work over
plan rows, not voxels: each warp sums a chunk of ``CHUNK_ROWS`` consecutive
rows, writes the voxels that lie wholly inside it and leaves one partial sum
for each voxel that crosses the chunk's edge; a second launch adds those in
chunk order and zeroes the empty voxels (``chip_smoke.chunk_partition``
describes that split for a plan). The kernels are forward-only and serve
inference. Training splats with the dynamic-rank ``lift_splat``
(``voxel_pool.py:89-103, 230-265`` of the JAX package): an ``index_add``
into an overflow bucket at ``num_voxels`` that is then dropped, which is
what the JAX package leaves to XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from ._dispatch import want_kernel

# Plan rows per warp of csrc/splat.cu; the flagship's longest voxel (1,360
# rows) spans 22 or 23 chunks. 64 ran faster than 128 on an H100
# (tools/probe_torch_splat.py).
CHUNK_ROWS = 64


def _segment_sum(vals: torch.Tensor, bounds: torch.Tensor,
                 num_voxels: int) -> torch.Tensor:
    """Sum rows [bounds[v], bounds[v+1]) of ``vals`` into voxel v."""
    counts = (bounds[1:] - bounds[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(num_voxels, device=vals.device), counts)
    out = vals.new_zeros(num_voxels, vals.shape[-1])
    return out.index_add_(0, seg, vals[:seg.numel()])


def lift_splat_fused_plain(dp, feat, order, bounds, group, num_voxels):
    """Plain version of K3, the JAX grouped math: lift every plan row,
    pre-reduce groups of ``group`` rows, then a sorted segment sum."""
    p_total = dp.numel()
    hw, c = feat.shape
    od = order.long()
    live = (od < p_total).float()
    odc = od.clamp(max=p_total - 1)
    vals = (dp.float()[odc] * live)[:, None] * feat.float()[odc % hw]
    vals = vals.view(-1, group, c).sum(1)
    return _segment_sum(vals, bounds, num_voxels)


def lift_splat_fused(
    dp: torch.Tensor,
    feat: torch.Tensor,
    order: torch.Tensor,
    bounds: torch.Tensor,
    group: int,
    num_voxels: int,
    use_kernel=None,
) -> torch.Tensor:
    """One sample's fused lift + splat -> [num_voxels, C] fp32.

    dp: [D*fH*fW] depth probabilities; feat: [fH*fW, C] context features
    (both fp32 or both bf16; the sums are fp32 either way, bf16 values
    widened exactly); order: [P_pad] int32 plan order; bounds:
    [num_voxels + 1] int32 group-row boundaries (``splat_plan.plan_bounds``).
    On a CUDA tensor this launches ``csrc/splat.cu``
    (stereoscene_splat_fused) or raises; on a CPU tensor it runs
    ``lift_splat_fused_plain``."""
    if not want_kernel("lift_splat_fused", use_kernel, dp, feat, order,
                       bounds):
        return lift_splat_fused_plain(dp, feat, order, bounds, group,
                                      num_voxels)
    hw, c = feat.shape
    p_total = dp.numel()
    _check_kernel_inputs("lift_splat_fused", dp, feat, order, bounds,
                         num_voxels, (torch.float32, torch.bfloat16))
    if p_total % hw:
        raise ValueError(f"dp of {p_total} is not a multiple of {hw} pixels")
    if order.numel() % group:
        raise ValueError(f"plan of {order.numel()} rows is not a multiple of "
                         f"group {group}")
    dp, feat = dp.contiguous(), feat.contiguous()
    order, bounds = order.contiguous(), bounds.contiguous()
    rows = _int32_rows("lift_splat_fused", order.numel())
    out = torch.empty((num_voxels, c), dtype=torch.float32, device=dp.device)
    partials = torch.empty((-(-rows // CHUNK_ROWS), 2, c),
                           dtype=torch.float32, device=dp.device)
    _build.launch(
        "lift_splat_fused", dp.get_device(), dp.data_ptr(), feat.data_ptr(),
        order.data_ptr(), bounds.data_ptr(), partials.data_ptr(),
        out.data_ptr(), num_voxels, c, group, p_total, hw, rows, CHUNK_ROWS,
        int(dp.dtype == torch.bfloat16))
    return out


def splat_sorted_plain(vals, ranks_sorted, num_voxels):
    """Plain version of K2: sorted segment sum (pad ranks >= num_voxels
    are dropped)."""
    rk = ranks_sorted.long()
    keep = rk < num_voxels
    out = vals.new_zeros(num_voxels, vals.shape[-1], dtype=torch.float32)
    return out.index_add_(0, rk[keep], vals.float()[keep])


def splat_sorted(
    vals: torch.Tensor,
    ranks_sorted: torch.Tensor,
    num_voxels: int,
    use_kernel=None,
) -> torch.Tensor:
    """Segment sum of rank-sorted rows [P, C] fp32 into [num_voxels, C].

    Pad rows carry ranks >= num_voxels. The kernel finds the row
    boundaries itself (``torch.searchsorted`` over the sorted ranks, left
    side). On a CUDA tensor this launches ``csrc/splat.cu``
    (stereoscene_splat_sorted) or raises."""
    if not want_kernel("splat_sorted", use_kernel, vals, ranks_sorted):
        return splat_sorted_plain(vals, ranks_sorted, num_voxels)
    if ranks_sorted.dtype != torch.int32:
        raise TypeError(f"ranks must be int32, got {ranks_sorted.dtype}")
    _check_kernel_inputs("splat_sorted", vals, vals, ranks_sorted, None,
                         num_voxels)
    if vals.shape[0] != ranks_sorted.shape[0]:
        raise ValueError("vals and ranks_sorted differ in rows")
    vals, ranks_sorted = vals.contiguous(), ranks_sorted.contiguous()
    rows = _int32_rows("splat_sorted", vals.shape[0])
    c = vals.shape[1]
    out = torch.empty((num_voxels, c), dtype=torch.float32,
                      device=vals.device)
    partials = torch.empty((-(-rows // CHUNK_ROWS), 2, c),
                           dtype=torch.float32, device=vals.device)
    bounds = torch.empty(num_voxels + 1, dtype=torch.int32,
                         device=vals.device)
    _build.launch(
        "splat_sorted", vals.get_device(), vals.data_ptr(),
        ranks_sorted.data_ptr(), bounds.data_ptr(), partials.data_ptr(),
        out.data_ptr(), num_voxels, c, rows, CHUNK_ROWS)
    return out


def _int32_rows(name, rows: int) -> int:
    if rows >= 2**31:
        raise ValueError(f"{name}: {rows} plan rows do not fit int32")
    return rows


def _check_kernel_inputs(name, table, feat, order, bounds, num_voxels,
                         dtypes=(torch.float32,)):
    if table.dtype != feat.dtype or table.dtype not in dtypes:
        raise TypeError(f"{name}: the splat kernel takes values of one "
                        f"dtype in {dtypes}, got {table.dtype} and "
                        f"{feat.dtype}")
    if order.dtype != torch.int32 or (bounds is not None
                                      and bounds.dtype != torch.int32):
        raise TypeError(f"{name}: plan arrays must be int32")
    if feat.dim() != 2 or order.dim() != 1:
        raise ValueError(f"{name}: expected 2D values and a 1D plan")
    if bounds is not None and bounds.shape != (num_voxels + 1,):
        raise ValueError(
            f"{name}: bounds {tuple(bounds.shape)} != ({num_voxels + 1},)")


def lift_splat_static(
    depth_prob: torch.Tensor,
    img_feat: torch.Tensor,
    order: torch.Tensor,
    ranks_sorted: torch.Tensor,
    grid_shape: Tuple[int, int, int],
    group: int = 1,
    bounds: "torch.Tensor | None" = None,
    use_kernel=None,
) -> torch.Tensor:
    """Fused lift + splat over a host-built static plan.

    depth_prob: [B, D, fH, fW]; img_feat: [B, fH, fW, C], both fp32 or
    both bf16 (the kernel widens bf16 itself, the plain version casts);
    order / ranks_sorted: [B, P_pad] int32; bounds: [B, num_voxels + 1]
    int32 (from ``ranks_sorted`` when None). Returns [B, X, Y, Z, C]
    fp32."""
    num_x, num_y, num_z = grid_shape
    num_voxels = num_x * num_y * num_z
    b, c = depth_prob.shape[0], img_feat.shape[-1]
    if bounds is None:
        grid = torch.arange(num_voxels + 1, device=ranks_sorted.device,
                            dtype=ranks_sorted.dtype)
        bounds = torch.stack([
            torch.searchsorted(ranks_sorted[i, ::group].contiguous(), grid,
                               out_int32=True)
            for i in range(b)])
    return torch.stack([
        lift_splat_fused(
            depth_prob[i].reshape(-1), img_feat[i].reshape(-1, c),
            order[i], bounds[i], group, num_voxels, use_kernel,
        ).view(num_x, num_y, num_z, c)
        for i in range(b)])


def voxel_pool_scatter(feats: torch.Tensor, ranks: torch.Tensor,
                       num_voxels: int) -> torch.Tensor:
    """Sum rows of ``feats`` [P, C] into [num_voxels, C] by ``ranks`` [P]
    in [0, num_voxels]; rank ``num_voxels`` is the overflow bucket of
    out-of-bounds points and is dropped. Differentiable."""
    out = feats.new_zeros(num_voxels + 1, feats.shape[-1])
    return out.index_add(0, ranks.long(), feats)[:num_voxels]


def lift_splat(
    depth_prob: torch.Tensor,
    img_feat: torch.Tensor,
    ranks: torch.Tensor,
    grid_shape: Tuple[int, int, int],
) -> torch.Tensor:
    """Lift (outer product) + splat with per-point voxel ranks.

    depth_prob: [B, D, fH, fW]; img_feat: [B, fH, fW, C]; ranks:
    [B, D*fH*fW] (sentinel ``X*Y*Z`` out of bounds). Returns
    [B, X, Y, Z, C] in the inputs' dtype."""
    num_x, num_y, num_z = grid_shape
    num_voxels = num_x * num_y * num_z
    b, d, fh, fw = depth_prob.shape
    c = img_feat.shape[-1]
    lifted = (depth_prob.reshape(b, d, fh * fw, 1)
              * img_feat.reshape(b, 1, fh * fw, c)).reshape(b, -1, c)
    return torch.stack([
        voxel_pool_scatter(lifted[i], ranks[i], num_voxels)
        for i in range(b)]).view(b, num_x, num_y, num_z, c)
