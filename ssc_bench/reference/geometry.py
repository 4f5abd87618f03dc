"""Lift-splat geometry of the plain reference, in float32 with the
reference's operation order (ref: ViewTransformerLSSBEVDepth.py:27-156,
ViewTransformerLSSVoxel.py:128-156, 440-449), and a frozen copy of the
numpy `build_plan`, whose row count the K3 roofline reads.

Nothing here imports the program: the reference derives every voxel rank
itself from the calibration the benchmark hands to both sides.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def gen_dx_bx(xbound: Sequence[float], ybound: Sequence[float],
              zbound: Sequence[float]):
    """Voxel sizes, first-voxel centres and grid extents."""
    bounds = [xbound, ybound, zbound]
    dx = np.array([row[2] for row in bounds], dtype=np.float32)
    bx = np.array([row[0] + row[2] / 2.0 for row in bounds], dtype=np.float32)
    nx = np.array([int(round((row[1] - row[0]) / row[2])) for row in bounds],
                  dtype=np.int32)
    return dx, bx, nx


def create_frustum(input_size: Tuple[int, int], downsample: int,
                   dbound: Sequence[float]) -> np.ndarray:
    """(u, v, depth) sample points, [D, fH, fW, 3]."""
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


def _apply(mat, points):
    if mat.dim() == 3:
        return torch.einsum("bij,bndhwj->bndhwi", mat, points)
    return torch.einsum("bnij,bndhwj->bndhwi", mat, points)


def get_geometry(frustum, rots, trans, intrins, post_rots, post_trans, bda):
    """[D, fH, fW, 3] frustum -> ego XYZ [B, N, D, fH, fW, 3] for KITTI
    3x4 intrinsics and a 3x3 ``bda``."""
    b, n = trans.shape[:2]
    f32 = torch.float32
    points = frustum.to(f32)[None, None] - post_trans.to(f32).reshape(
        b, n, 1, 1, 1, 3)
    points = _apply(torch.linalg.inv(post_rots.to(f32)), points)
    points = torch.cat([points[..., :2] * points[..., 2:3], points[..., 2:3]],
                       dim=-1)
    shift = intrins[..., :3, 3].to(f32)
    points = points - shift.reshape(b, n, 1, 1, 1, 3)
    combine = torch.einsum("bnij,bnjk->bnik", rots.to(f32),
                           torch.linalg.inv(intrins[..., :3, :3].to(f32)))
    points = _apply(combine, points)
    points = points + trans.to(f32).reshape(b, n, 1, 1, 1, 3)
    return _apply(bda.to(f32), points)


def get_mlp_input(rot, tran, intrin, post_rot, post_tran, bda):
    """The 30-wide camera vector [B, N, 30] of the camera-aware SE."""
    b, n = rot.shape[:2]
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
    sensor2ego = torch.cat([rot, tran.reshape(b, n, 3, 1)], dim=-1)
    return torch.cat([torch.stack(feats, dim=-1),
                      sensor2ego.reshape(b, n, 12)], dim=-1)


def voxel_ranks(geom, xbound, ybound, zbound) -> torch.Tensor:
    """Linear voxel ranks of ego points [..., 3] (truncating quantisation),
    ``X*Y*Z`` where a point lies outside the grid."""
    dx, bx, nx = gen_dx_bx(xbound, ybound, zbound)
    dx_t = torch.as_tensor(dx, dtype=geom.dtype, device=geom.device)
    bx_t = torch.as_tensor(bx, dtype=geom.dtype, device=geom.device)
    nx_t = torch.as_tensor(nx, dtype=torch.int32, device=geom.device)
    coords = ((geom - (bx_t - dx_t / 2.0)) / dx_t).to(torch.int32)
    valid = ((coords >= 0) & (coords < nx_t)).all(dim=-1)
    x, y, z = (int(v) for v in nx)
    ranks = coords[..., 0] * (y * z) + coords[..., 1] * z + coords[..., 2]
    return torch.where(valid, ranks, torch.full_like(ranks, x * y * z))


def disparity_positions(calib: torch.Tensor, num_depth: int) -> torch.Tensor:
    """[B, D] fractional disparity positions ``calib / 4 / k``."""
    k = torch.arange(1, num_depth + 1, dtype=torch.float32,
                     device=calib.device)
    return calib.to(torch.float32)[:, None] / 4.0 / k[None, :]


def plan_rows(ranks: np.ndarray, num_voxels: int, group: int) -> dict:
    """Rows of a static splat plan over ``ranks`` [P] with every voxel's
    run padded to a multiple of ``group`` (``build_plan``'s
    padding, frozen here): ``rows`` padded in-bounds rows, ``live`` the
    in-bounds points among them, ``padded`` the plan length after the
    budget (the in-bounds rows x 1.1, rounded up to 1024, plus
    1024)."""
    keep = ranks[ranks < num_voxels]
    if group > 1 and len(keep):
        counts = np.unique(keep, return_counts=True)[1]
        rows = int(((counts + group - 1) // group * group).sum())
    else:
        rows = int(len(keep))
    n = int(rows * 1.1)
    padded = (n + 1023) // 1024 * 1024 + 1024
    return {"rows": rows, "live": int(len(keep)), "padded": padded}
