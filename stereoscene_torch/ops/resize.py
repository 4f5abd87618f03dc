"""Trilinear voxel resize, port of ``stereoscene_tpu/ops/resize.py``.

Half-pixel centres with clamped edges: ``F.interpolate(mode="trilinear",
align_corners=False)`` for upsampling, which is what the reference's final
voxel upsample uses (bevdepth_occupancy.py:293-294) and what the JAX
package's ``jax.image.resize`` / exact-2x stencil computes
(tests/test_torch_modules.py holds the two against each other).

An axis that shrinks (the fine-to-coarse fusion of ``SpconvNeck3D``) takes
``jax.image.resize``'s linear weights as they are there, antialiased: the
triangle kernel widened by the inverse scale, each output's weights
normalised to sum 1 (``_linear_weights``), which ``F.interpolate`` does
not compute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of ``jax.image.resize(method="linear")``
    along one axis (jax/_src/image/scale.py ``compute_weight_mat``)."""
    inv = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = (sample[:, None] - src[None, :]).abs() / max(inv, 1.0)
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return w * inside[:, None]


def resize_trilinear(x: torch.Tensor, out_xyz) -> torch.Tensor:
    """[..., X, Y, Z, C] -> [..., X', Y', Z', C]."""
    lead = x.shape[:-4]
    c = x.shape[-1]
    out_xyz = tuple(int(n) for n in out_xyz)
    if all(o >= i for o, i in zip(out_xyz, x.shape[-4:-1])):
        vol = x.reshape(-1, *x.shape[-4:]).permute(0, 4, 1, 2, 3)
        out = F.interpolate(vol, size=out_xyz, mode="trilinear",
                            align_corners=False)
        return out.permute(0, 2, 3, 4, 1).reshape(*lead, *out_xyz, c)
    y = x.float()
    for axis, n_out in zip((-4, -3, -2), out_xyz):
        w = _linear_weights(y.shape[axis], n_out, x.device)
        y = torch.movedim(torch.tensordot(w, torch.movedim(y, axis, 0),
                                          dims=1), 0, axis)
    return y.to(x.dtype)
