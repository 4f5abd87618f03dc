"""Depth supervision of the LSS lift, port of
``stereoscene_tpu/losses/depth.py`` (ref: ViewTransformerLSSVoxel.py:349-388):
the sparse LiDAR depth is min-pooled to the feature stride (zero = no
return), binned into the D depth bins as a one-hot target, and the
predicted depth distribution takes a binary cross-entropy on the
foreground pixels, normalised by their count: in a process group
(``parallel``) the loss sum and the count are pooled over the ranks, so it
is the global batch's loss.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel import all_sum

_EPS = 1e-12
_LOG_CLAMP = -100.0


def downsample_gt_depth(gt_depths: torch.Tensor, downsample: int,
                        dbound: Tuple[float, float, float],
                        num_depth: int) -> torch.Tensor:
    """[B, N, H, W] metric depth (0 = no return) -> one-hot
    [B*N*h*w, D] fp32 (all-zero rows: background)."""
    b, n, h, w = gt_depths.shape
    d = downsample
    x = gt_depths.float().reshape(b * n, h // d, d, w // d, d)
    x = torch.where(x == 0.0, torch.full_like(x, 1e5), x).amin(dim=(2, 4))
    lo, _, step = dbound
    idx = (x - (lo - step / 2.0)) / step
    in_range = (idx < num_depth + 1) & (idx >= 0.0)
    idx = torch.where(in_range, idx, torch.zeros_like(idx)).long()
    return F.one_hot(idx.reshape(-1), num_depth + 1).float()[:, 1:]


def bce_depth_loss(depth_labels: torch.Tensor, depth_probs: torch.Tensor,
                   downsample: int,
                   dbound: Tuple[float, float, float]) -> torch.Tensor:
    """depth_labels [B, N, H, W] sparse metric depth; depth_probs
    [B*N, h, w, D] predicted distribution (channels-last, the JAX
    package's layout)."""
    num_depth = depth_probs.shape[-1]
    labels = downsample_gt_depth(depth_labels, downsample, dbound, num_depth)
    preds = depth_probs.float().reshape(-1, num_depth)
    fg = (labels.amax(dim=1) > 0.0).float()
    log_p = torch.log(preds.clamp(_EPS, 1.0)).clamp_min(_LOG_CLAMP)
    log_q = torch.log((1.0 - preds).clamp(_EPS, 1.0)).clamp_min(_LOG_CLAMP)
    bce = -(labels * log_p + (1.0 - labels) * log_q)
    num, den = all_sum(torch.stack([(bce.sum(dim=1) * fg).sum(), fg.sum()]))
    return num / den.clamp_min(1.0)
