"""Temporal (4D) occupancy: ego-motion alignment of the previous frame's
voxel features and their fusion with the current ones, port of
``stereoscene_tpu/models/temporal.py`` (ref: occupancy/detectors/
bevdepth.py:181-293 ``shift_feature``, bevdepth_occupancy.py:362-419
``BEVDepthOccupancy4D``).

The previous frame's features [B, X, Y, Z, C] (channels-last, as in the
JAX package) are resampled along the BEV plane into the current ego frame
(the same XY warp at every Z; bilinear, zero padding, cell indices used
directly, i.e. align_corners=True), then concatenated on channels.
Gradients flow through the key frame only (``detach_prev``). The 4x4
inverse is fp32 and the small products are elementwise sums in fp32, not
matmuls, so TF32 never touches them (the JAX package computes them at
``Precision.HIGHEST``).
"""

from __future__ import annotations

import numpy as np
import torch


def _matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., i, j] @ [..., j, k] as an fp32 elementwise product and sum."""
    return (a.float()[..., :, :, None] * b.float()[..., None, :, :]).sum(-2)


def relative_bev_transform(rots_curr: torch.Tensor, trans_curr: torch.Tensor,
                           rots_adj: torch.Tensor,
                           trans_adj: torch.Tensor) -> torch.Tensor:
    """Current-lidar -> adjacent-lidar 2D homogeneous transform [B, 3, 3]:
    l0 -> l1 = c2l0 @ inv(c2l1) (ref bevdepth.py:208-224), reduced to the
    (x, y, 1) plane by dropping the z row and column (ref :226-227)."""
    b = rots_curr.shape[0]

    def to44(r, t):
        m = torch.zeros((b, 4, 4), dtype=torch.float32, device=r.device)
        m[:, :3, :3] = r.float()
        m[:, :3, 3] = t.float()
        m[:, 3, 3] = 1.0
        return m

    l02l1 = _matmul32(to44(rots_curr, trans_curr),
                      torch.linalg.inv(to44(rots_adj, trans_adj)))
    keep = torch.tensor([0, 1, 3], device=l02l1.device)
    return l02l1[:, keep][:, :, keep]


def shift_voxel_feature(feat: torch.Tensor, bev_tf: torch.Tensor,
                        dx: np.ndarray, bx: np.ndarray) -> torch.Tensor:
    """Resample [B, X, Y, Z, C] along the BEV plane by ``bev_tf`` [B, 3, 3]:
    cell (ix, iy) -> metric (feat2bev, ref :231-241), warped, back to
    cells, bilinear with zero padding."""
    b, nx, ny, nz, c = feat.shape
    dev = feat.device
    gx, gy = torch.meshgrid(torch.arange(nx, dtype=torch.float32, device=dev),
                            torch.arange(ny, dtype=torch.float32, device=dev),
                            indexing="ij")
    ox, oy = float(bx[0] - dx[0] / 2.0), float(bx[1] - dx[1] / 2.0)
    pts = torch.stack([gx * float(dx[0]) + ox, gy * float(dx[1]) + oy,
                       torch.ones_like(gx)], dim=-1)  # [X, Y, 3]
    warped = (bev_tf.float()[:, None, None] * pts[None, :, :, None, :]).sum(-1)
    sx = (warped[..., 0] - ox) / float(dx[0])
    sy = (warped[..., 1] - oy) / float(dx[1])
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    flat = feat.reshape(b, nx * ny, nz * c)

    def gather(xi, yi, w):
        inside = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
        idx = (xi.clamp(0, nx - 1) * ny + yi.clamp(0, ny - 1)).reshape(b, -1)
        g = flat.gather(1, idx[..., None].expand(-1, -1, nz * c))
        return g * (w * inside).reshape(b, -1, 1).to(feat.dtype)

    out = (gather(x0, y0, (1 - fx) * (1 - fy))
           + gather(x0 + 1, y0, fx * (1 - fy))
           + gather(x0, y0 + 1, (1 - fx) * fy)
           + gather(x0 + 1, y0 + 1, fx * fy))
    return out.reshape(b, nx, ny, nz, c)


def fuse_temporal_voxel_features(curr_feat: torch.Tensor,
                                 prev_feat: torch.Tensor, batch_curr,
                                 batch_prev, dx: np.ndarray, bx: np.ndarray,
                                 detach_prev: bool = True) -> torch.Tensor:
    """Align ``prev_feat`` into the current frame and concat on channels
    (ref bevdepth.py:289-293); the poses are the lifted (left) camera's."""
    if detach_prev:
        prev_feat = prev_feat.detach()
    tf = relative_bev_transform(
        batch_curr["rots"][:, 0], batch_curr["trans"][:, 0],
        batch_prev["rots"][:, 0], batch_prev["trans"][:, 0])
    aligned = shift_voxel_feature(prev_feat, tf, dx, bx)
    return torch.cat([curr_feat, aligned], dim=-1)
