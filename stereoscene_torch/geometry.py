"""Lift-splat-shoot geometry in PyTorch.

Counterpart of ``stereoscene_tpu/geometry.py`` (same names, same layouts):

- ``gen_dx_bx``        grid spacing / first-voxel centres / extents (numpy)
- ``create_frustum``   [D, fH, fW, 3] (u, v, depth) sample points (numpy)
- ``get_geometry``     frustum -> ego XYZ, with the KITTI 3x4-intrinsics shift
- ``get_mlp_input``    the 30-dim camera embedding of the camera-aware SE
- ``voxel_indices``    truncating quantisation + in-bounds mask
- ``flatten_voxel_ranks`` linear ranks with the ``X*Y*Z`` out-of-bounds
  sentinel
- ``disparity_positions`` depth bin -> disparity-axis sample positions

All math is float32 with the reference's operation order, so ranks computed
on the CPU are integer-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def gen_dx_bx(
    xbound: Sequence[float], ybound: Sequence[float], zbound: Sequence[float]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Voxel sizes ``dx``, first-voxel centres ``bx``, grid extents ``nx``
    (ref: ViewTransformerLSSBEVDepth.py:27-31)."""
    bounds = [xbound, ybound, zbound]
    dx = np.array([row[2] for row in bounds], dtype=np.float32)
    bx = np.array([row[0] + row[2] / 2.0 for row in bounds], dtype=np.float32)
    nx = np.array(
        [int(round((row[1] - row[0]) / row[2])) for row in bounds],
        dtype=np.int32,
    )
    return dx, bx, nx


def create_frustum(
    input_size: Tuple[int, int], downsample: int, dbound: Sequence[float]
) -> np.ndarray:
    """Frustum of (u, v, d) sample points, [D, fH, fW, 3]
    (ref: ViewTransformerLSSBEVDepth.py:110-121)."""
    ogf_h, ogf_w = input_size
    f_h, f_w = ogf_h // downsample, ogf_w // downsample
    ds = np.arange(dbound[0], dbound[1], dbound[2], dtype=np.float32)
    num_d = ds.shape[0]
    ds = np.broadcast_to(ds[:, None, None], (num_d, f_h, f_w))
    xs = np.linspace(0, ogf_w - 1, f_w, dtype=np.float32)
    xs = np.broadcast_to(xs[None, None, :], (num_d, f_h, f_w))
    ys = np.linspace(0, ogf_h - 1, f_h, dtype=np.float32)
    ys = np.broadcast_to(ys[None, :, None], (num_d, f_h, f_w))
    return np.stack([xs, ys, ds], axis=-1)


def _apply(mat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[B, N, 3, 3] (or [B, 3, 3] shared over N) x [B, N, D, H, W, 3]."""
    if mat.dim() == 3:
        return torch.einsum("bij,bndhwj->bndhwi", mat, points)
    return torch.einsum("bnij,bndhwj->bndhwi", mat, points)


def get_geometry(
    frustum: torch.Tensor,
    rots: torch.Tensor,
    trans: torch.Tensor,
    intrins: torch.Tensor,
    post_rots: torch.Tensor,
    post_trans: torch.Tensor,
    bda: torch.Tensor,
) -> torch.Tensor:
    """Map the [D, fH, fW, 3] frustum into ego XYZ, [B, N, D, fH, fW, 3]
    (ref: ViewTransformerLSSBEVDepth.py:123-156): undo the image
    post-augmentation, (u*d, v*d, d), subtract the KITTI projection
    translation column, rots @ inv(K), + trans, then ``bda``."""
    b, n = trans.shape[:2]
    f32 = torch.float32
    points = frustum.to(f32)[None, None] - post_trans.to(f32).reshape(
        b, n, 1, 1, 1, 3)
    points = _apply(torch.linalg.inv(post_rots.to(f32)), points)
    points = torch.cat(
        [points[..., :2] * points[..., 2:3], points[..., 2:3]], dim=-1)
    if intrins.shape[-1] == 4:
        shift = intrins[..., :3, 3].to(f32)
        points = points - shift.reshape(b, n, 1, 1, 1, 3)
        intrins = intrins[..., :3, :3]
    combine = torch.einsum(
        "bnij,bnjk->bnik", rots.to(f32), torch.linalg.inv(intrins.to(f32)))
    points = _apply(combine, points)
    points = points + trans.to(f32).reshape(b, n, 1, 1, 1, 3)
    bda = bda.to(f32)
    if bda.shape[-1] == 4:
        homo = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
        return torch.einsum("bij,bndhwj->bndhwi", bda, homo)[..., :3]
    return _apply(bda, points)


def get_mlp_input(
    rot: torch.Tensor,
    tran: torch.Tensor,
    intrin: torch.Tensor,
    post_rot: torch.Tensor,
    post_tran: torch.Tensor,
    bda: torch.Tensor,
) -> torch.Tensor:
    """Camera-parameter vector [B, N, C_cam] for KITTI 3x4 intrinsics
    (ref: ViewTransformerLSSBEVDepth.py:604-659): 7 intrinsic entries, 6
    post-aug entries, 5 bda entries, with a 4x4 ``bda`` its translation
    column (3), then the flattened 3x4 [rot|tran] sensor-to-ego matrix:
    30 wide with a 3x3 ``bda``, 33 with a 4x4 one, as the JAX package's
    ``geometry.get_mlp_input`` (geometry.py:207-208)."""
    b, n = rot.shape[:2]
    if intrin.shape[-1] != 4:
        raise NotImplementedError(
            "get_mlp_input: only 3x4 (KITTI) intrinsics")
    bda_n = bda[:, None].expand((b, n) + tuple(bda.shape[-2:]))
    feats = [
        intrin[:, :, 0, 0], intrin[:, :, 1, 1],
        intrin[:, :, 0, 2], intrin[:, :, 1, 2],
        intrin[:, :, 0, 3], intrin[:, :, 1, 3], intrin[:, :, 2, 3],
        post_rot[:, :, 0, 0], post_rot[:, :, 0, 1], post_tran[:, :, 0],
        post_rot[:, :, 1, 0], post_rot[:, :, 1, 1], post_tran[:, :, 1],
        bda_n[:, :, 0, 0], bda_n[:, :, 0, 1], bda_n[:, :, 1, 0],
        bda_n[:, :, 1, 1], bda_n[:, :, 2, 2],
    ]
    parts = [torch.stack(feats, dim=-1)]
    if bda.shape[-1] == 4:
        parts.append(bda_n[:, :, :3, -1])
    sensor2ego = torch.cat([rot, tran.reshape(b, n, 3, 1)], dim=-1)
    return torch.cat(parts + [sensor2ego.reshape(b, n, 12)], dim=-1)


def voxel_indices(
    geom: torch.Tensor, dx: np.ndarray, bx: np.ndarray, nx: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer voxel coordinates (truncated toward zero, as the reference's
    ``.long()``) and the in-bounds mask
    (ref: ViewTransformerLSSVoxel.py:440-449)."""
    dx_t = torch.as_tensor(dx, dtype=geom.dtype, device=geom.device)
    bx_t = torch.as_tensor(bx, dtype=geom.dtype, device=geom.device)
    nx_t = torch.as_tensor(nx, dtype=torch.int32, device=geom.device)
    coords = ((geom - (bx_t - dx_t / 2.0)) / dx_t).to(torch.int32)
    valid = ((coords >= 0) & (coords < nx_t)).all(dim=-1)
    return coords, valid


def flatten_voxel_ranks(
    coords: torch.Tensor, valid: torch.Tensor, nx: np.ndarray
) -> torch.Tensor:
    """Linear ranks in [0, X*Y*Z); out-of-bounds points get ``X*Y*Z``."""
    num_x, num_y, num_z = (int(v) for v in nx)
    ranks = (coords[..., 0] * (num_y * num_z) + coords[..., 1] * num_z
             + coords[..., 2])
    return torch.where(valid, ranks, torch.full_like(ranks, num_x * num_y
                                                      * num_z))


def disparity_positions(calib: torch.Tensor, num_depth: int) -> torch.Tensor:
    """[B, D] fractional disparity positions ``calib / 4 / k``, k = 1..D
    (ref: ViewTransformerLSSVoxel.py:128-156)."""
    k = torch.arange(1, num_depth + 1, dtype=torch.float32,
                     device=calib.device)
    return calib.to(torch.float32)[:, None] / 4.0 / k[None, :]
