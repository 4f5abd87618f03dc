"""Auxiliary SSC losses of the reference's loss zoo, port of
``stereoscene_tpu/losses/extras.py``.

- ``soft_dice_loss``: binary occupancy dice on probabilities
  (ref: utils/dice_loss.py SoftDiceLossWithProb / V1).
- ``position_aware_loss`` (LGA): CE weighted by a local-geometric-anisotropy
  factor, voxels whose 6-neighbourhood has many class changes up-weighted
  (ref: utils/pal_loss.py:9 PositionAwareLoss).
- ``frustum_proportion_loss``: MonoScene-style KL between per-frustum class
  proportion distributions (ref: utils/semkitti.py:218-243
  compute_frustum_dist_loss).
- ``gaussian_depth_target`` + ``klv_depth_loss``: Gaussian-smoothed depth
  supervision (ref: utils/gaussian.py:90-130 generate_guassian_depth_target,
  ViewTransformerLSSVoxel.py:390-403 get_klv_depth_loss).

Over ranks (``parallel``) every sum over the batch pools through
``all_sum`` before a division, as in ``losses/semkitti.py``; the depth
loss over the data group, as ``losses/depth.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel import all_sum, data_group, space_rank, space_size, spatial

_EPS = 1e-12


def soft_dice_loss(occ_probs: torch.Tensor, target: torch.Tensor,
                   smooth: float = 1.0) -> torch.Tensor:
    """occ_probs: [...] P(occupied); target int labels (255 ignored)."""
    p = occ_probs.float().reshape(-1)
    t = target.reshape(-1)
    valid = (t != 255).float()
    occ = ((t > 0) & (t != 255)).float()
    p = p * valid
    inter, p_sum, occ_sum = all_sum(torch.stack([
        (p * occ).sum(), p.sum(), occ.sum()]))
    return 1.0 - (2.0 * inter + smooth) / (p_sum + occ_sum + smooth)


def _padded_labels(t: torch.Tensor) -> torch.Tensor:
    """int64 labels [B, X, Y, Z] with one plane more on each side of X, Y
    and Z: the ignore label 255 past the grid's ends, and on an X slab of
    a sharded grid (``parallel.spatial``) the neighbours' boundary planes
    along X (a 1-plane label halo)."""
    if spatial.active():
        t = spatial.halo(t, 1, 1, dim=1)
        if space_rank() == 0:
            t[:, 0] = 255
        if space_rank() == space_size() - 1:
            t[:, -1] = 255
    else:
        t = F.pad(t, (0, 0, 0, 0, 1, 1), value=255)
    return F.pad(t, (1, 1, 1, 1), value=255)


def local_geometric_anisotropy(target: torch.Tensor) -> torch.Tensor:
    """Count of 6-neighbours with a different (valid) class per voxel of
    target [B, X, Y, Z] (ref pal_loss.py: M_LGA, the number of
    semantically different neighbours; no neighbour past the grid's ends);
    float32."""
    t = target.long()
    valid = t != 255
    padded = _padded_labels(t)
    counts = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    for axis in (1, 2, 3):
        n = t.shape[axis]
        for start in (0, 2):
            nb = padded.narrow(axis, start, n)
            for other in {1, 2, 3} - {axis}:
                nb = nb.narrow(other, 1, t.shape[other])
            counts += ((nb != t) & (nb != 255) & valid).float()
    return counts


def position_aware_loss(logits: torch.Tensor, target: torch.Tensor,
                        class_weights,
                        lga_weight: float = 1.0) -> torch.Tensor:
    """CE with per-voxel (1 + LGA) weighting (ref pal_loss.py:9-60)."""
    c = logits.shape[-1]
    lga = 1.0 + lga_weight * local_geometric_anisotropy(target).reshape(-1)
    logp = torch.log_softmax(logits.float().reshape(-1, c), dim=-1)
    t = target.reshape(-1).long()
    valid = t != 255
    safe = torch.where(valid, t, 0)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)[safe] * lga
    w = torch.where(valid, w, torch.zeros_like(w))
    num, den = all_sum(torch.stack([(nll * w).sum(), w.sum()]))
    return num / den.clamp_min(_EPS)


def frustum_proportion_loss(logits: torch.Tensor,
                            frustum_masks: torch.Tensor,
                            frustum_class_dists: torch.Tensor
                            ) -> torch.Tensor:
    """KL between predicted and target class proportions per frustum.

    Args:
      logits: [B, X, Y, Z, C].
      frustum_masks: [B, F, X, Y, Z] bool.
      frustum_class_dists: [B, F, C] target class counts.
    ref: semkitti.py:218-243
    """
    probs = torch.softmax(logits.float(), dim=-1)
    masks = frustum_masks.float()
    cum_prob = torch.einsum("bfxyz,bxyzc->fc", masks, probs)   # [F, C]
    batch_cnt = frustum_class_dists.float().sum(0)             # [F, C]
    cum_prob, batch_cnt = all_sum(torch.stack([cum_prob, batch_cnt]))
    total_cnt = batch_cnt.sum(1, keepdim=True)
    total_prob = cum_prob.sum(1, keepdim=True)
    tgt = batch_cnt / total_cnt.clamp_min(_EPS)
    pred = cum_prob / total_prob.clamp_min(_EPS)
    kl = torch.where(
        tgt != 0,
        tgt * (torch.log(tgt.clamp_min(_EPS))
               - torch.log(pred.clamp_min(_EPS))),
        torch.zeros_like(tgt)).sum(1)
    use = ((total_prob > 0) & (total_cnt > 0))[:, 0]
    loss = torch.where(use, kl, torch.zeros_like(kl)).sum()
    return loss / use.float().sum().clamp_min(1.0)


def gaussian_depth_target(gt_depths: torch.Tensor, downsample: int,
                          dbound: Tuple[float, float, float],
                          num_depth: int, constant_std: float = 0.5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel Gaussian distribution over depth bins from the min-pooled
    LiDAR depth, as the reference computes it (ref: utils/gaussian.py:
    90-130), with its two quirks: the Normal's mean and std are divided by
    the bin interval while its CDF is evaluated at raw-depth bin edges
    ``lo - step/2 + k*step``, and the bin masses are raw CDF differences,
    not renormalised. Patches with no LiDAR return get depth 0.

    Returns (gaussian [B*N*h*w, D], depth_values [B*N*h*w])."""
    b, n, h, w = gt_depths.shape
    d = downsample
    x = gt_depths.float().reshape(b * n, h // d, d, w // d, d)
    x = torch.where(x == 0.0, torch.full_like(x, 1e10), x)
    depth_vals = x.amin(dim=(2, 4)).reshape(-1)
    depth_vals = torch.where(depth_vals == 1e10,
                             torch.zeros_like(depth_vals), depth_vals)

    lo, _, step = dbound
    edges = (lo - step / 2) + step * torch.arange(
        num_depth + 1, dtype=torch.float32, device=gt_depths.device)
    mu = depth_vals / step
    sigma = constant_std / step
    z = (edges[None, :] - mu[:, None]) / (sigma * 2.0 ** 0.5)
    cdf = 0.5 * (1.0 + torch.erf(z))
    return cdf[:, 1:] - cdf[:, :-1], depth_vals


def klv_depth_loss(gt_depths: torch.Tensor, depth_probs: torch.Tensor,
                   downsample: int, dbound: Tuple[float, float, float],
                   constant_std: float = 0.5) -> torch.Tensor:
    """KL(gaussian target || depth_pred) on in-range pixels (ref:
    ViewTransformerLSSVoxel.py:390-403; batchmean over those pixels).
    ``depth_probs`` [B*N, h, w, D], channels-last."""
    num_depth = depth_probs.shape[-1]
    target, depth_vals = gaussian_depth_target(
        gt_depths, downsample, dbound, num_depth, constant_std)
    lo, hi, step = dbound
    fg = (depth_vals >= lo) & (depth_vals <= hi - step)
    preds = depth_probs.float().reshape(-1, num_depth)
    logp = torch.log(preds + 1e-4)
    per_pix = (target * (torch.log(target.clamp_min(_EPS)) - logp)).sum(1)
    per_pix = torch.where(fg, per_pix, torch.zeros_like(per_pix))
    num, den = all_sum(torch.stack([per_pix.sum(), fg.float().sum()]),
                       data_group())
    return num / den.clamp_min(1.0)
