"""The published loss terms of the plain reference, in float32 (ref:
projects/mmdet3d_plugin/utils/semkitti.py, ViewTransformerLSSVoxel.py
:349-388): class-weighted voxel cross-entropy, sem_scal and geo_scal on
the logits upsampled to the label grid, and the BCE depth loss on the
fused depth distribution. Labels: ``gt_occ`` [B, X, Y, Z] with 255 as
ignore; ``gt_depth`` [B, N, H, W] sparse metric depth, 0 where no return.

Each voxel term is a ratio of sums over the label grid. Labels of more
than ``BLOCK_VOXELS`` voxels are summed block by block (a frame's slab of
X), each block recomputed in the backward, so that the float32 reference
of a large grid fits the card; the terms are the same ratios of the same
sums.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import upsample

# the label voxels of one block of the voxel terms
BLOCK_VOXELS = 2 ** 22

# ref: semkitti.py:8-31
CLASS_FREQUENCIES = np.array([
    5.41773033e09, 1.57835390e07, 1.25136000e05, 1.18809000e05,
    6.46799000e05, 8.21951000e05, 2.62978000e05, 2.83696000e05,
    2.04750000e05, 6.16887030e07, 4.50296100e06, 4.48836500e07,
    2.26992300e06, 5.68402180e07, 1.57196520e07, 1.58442623e08,
    2.06162300e06, 3.69705220e07, 1.15198800e06, 3.34146000e05,
])
_EPS = 1e-12


def _neg_log(p):
    return -torch.log(p.clamp_min(_EPS)).clamp_min(-100.0)


def ce_sums(logits, target):
    """logits [N, C] fp32, target [N] -> (weighted NLL sum, weight sum)."""
    weights = torch.as_tensor(1.0 / np.log(CLASS_FREQUENCIES + 0.001),
                              dtype=torch.float32, device=logits.device)
    valid = target != 255
    safe = torch.where(valid, target, 0)
    nll = -torch.log_softmax(logits, dim=-1).gather(1, safe[:, None])[:, 0]
    w = weights[safe] * valid
    return (nll * w).sum(), w.sum()


def ce_of(nll_sum, w_sum):
    return nll_sum / w_sum.clamp_min(_EPS)


def ce_ssc(logits, target):
    return ce_of(*ce_sums(logits, target))


def geo_sums(probs, target):
    empty = probs[:, 0]
    valid = (target != 255).float()
    nonempty_t = ((target != 0) & (target != 255)).float()
    empty_t = valid - nonempty_t
    nonempty = (1.0 - empty) * valid
    empty = empty * valid
    return ((nonempty_t * nonempty).sum(), nonempty.sum(), nonempty_t.sum(),
            (empty_t * empty).sum(), empty_t.sum())


def geo_of(inter, nonempty, nonempty_t, spec_nom, empty_t):
    precision = inter / nonempty.clamp_min(_EPS)
    recall = inter / nonempty_t.clamp_min(_EPS)
    spec = spec_nom / empty_t.clamp_min(_EPS)
    return _neg_log(precision) + _neg_log(recall) + _neg_log(spec)


def geo_scal(probs, target):
    return geo_of(*geo_sums(probs, target))


def sem_sums(probs, target):
    c = probs.shape[-1]
    validf = (target != 255).float()[:, None]
    classes = torch.arange(c, device=target.device, dtype=target.dtype)
    completion = (target[:, None] == classes[None, :]).float() * validf
    probs = probs * validf
    return ((probs * completion).sum(0), probs.sum(0), completion.sum(0),
            ((1.0 - probs) * (1.0 - completion) * validf).sum(0),
            validf.sum())


def sem_of(nominator, p_sum, t_sum, spec_nom, valid_sum):
    not_t_sum = valid_sum - t_sum
    zero = torch.zeros_like(p_sum)
    loss_c = (torch.where(p_sum > 0, _neg_log(nominator
                                              / p_sum.clamp_min(_EPS)), zero)
              + torch.where(t_sum > 0, _neg_log(nominator
                                                / t_sum.clamp_min(_EPS)), zero)
              + torch.where(not_t_sum > 0,
                            _neg_log(spec_nom / not_t_sum.clamp_min(_EPS)),
                            zero))
    present = (t_sum > 0).float()
    return (loss_c * present).sum() / present.sum().clamp_min(1.0)


def sem_scal(probs, target):
    return sem_of(*sem_sums(probs, target))


def _block_sums(up, gt):
    """The sums of the three voxel terms over one block: ``up`` [b, C, x,
    Y, Z] logits on the label grid, ``gt`` [b, x, Y, Z]."""
    flat = up.permute(0, 2, 3, 4, 1).reshape(-1, up.shape[1])
    target = gt.reshape(-1).long()
    probs = torch.softmax(flat, dim=-1)
    return (*ce_sums(flat, target), *sem_sums(probs, target),
            *geo_sums(probs, target))


def voxel_terms(up, gt):
    """(ce_ssc, sem_scal, geo_scal) of logits ``up`` [B, C, X, Y, Z] on
    the label grid against ``gt`` [B, X, Y, Z]."""
    if gt.numel() <= BLOCK_VOXELS:
        c = up.shape[1]
        flat = up.permute(0, 2, 3, 4, 1).reshape(-1, c)
        target = gt.reshape(-1).long()
        probs = torch.softmax(flat, dim=-1)
        return (ce_ssc(flat, target), sem_scal(probs, target),
                geo_scal(probs, target))
    slabs = -(-gt[0].numel() // BLOCK_VOXELS)
    sums = None
    for i in range(gt.shape[0]):
        for xs in torch.arange(gt.shape[1]).tensor_split(slabs):
            lo, hi = int(xs[0]), int(xs[-1]) + 1
            block = checkpoint(_block_sums, up[i:i + 1, :, lo:hi],
                               gt[i:i + 1, lo:hi], use_reentrant=False)
            sums = block if sums is None else [a + b for a, b in
                                               zip(sums, block)]
    return ce_of(*sums[:2]), sem_of(*sums[2:7]), geo_of(*sums[7:])


def bce_depth(gt_depth, depth_prob, downsample: int,
              dbound: Sequence[float]):
    """gt_depth [B, 1, H, W]; depth_prob [B, D, fH, fW]: min-pooled LiDAR
    depth binned one-hot, BCE on the foreground pixels over their count."""
    b, n, h, w = gt_depth.shape
    d = depth_prob.shape[1]
    x = gt_depth.float().reshape(b * n, h // downsample, downsample,
                                 w // downsample, downsample)
    x = torch.where(x == 0.0, torch.full_like(x, 1e5), x).amin(dim=(2, 4))
    lo, _, step = dbound
    idx = (x - (lo - step / 2.0)) / step
    in_range = (idx < d + 1) & (idx >= 0.0)
    idx = torch.where(in_range, idx, torch.zeros_like(idx)).long()
    labels = F.one_hot(idx.reshape(-1), d + 1).float()[:, 1:]
    preds = depth_prob.permute(0, 2, 3, 1).reshape(-1, d)
    fg = (labels.amax(dim=1) > 0.0).float()
    log_p = torch.log(preds.clamp(_EPS, 1.0)).clamp_min(-100.0)
    log_q = torch.log((1.0 - preds).clamp(_EPS, 1.0)).clamp_min(-100.0)
    bce = -(labels * log_p + (1.0 - labels) * log_q)
    return (bce.sum(dim=1) * fg).sum() / fg.sum().clamp_min(1.0)


def losses(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
           weights: Dict[str, float], downsample: int,
           dbound: Sequence[float]) -> Dict[str, torch.Tensor]:
    """The published terms by the program's names."""
    gt = batch["gt_occ"]
    ce, sem, geo = voxel_terms(upsample(outputs["logits"], gt.shape[1:]), gt)
    out = {"loss_voxel_ce_0": weights["voxel_ce"] * ce,
           "loss_voxel_sem_scal_0": weights["voxel_sem_scal"] * sem,
           "loss_voxel_geo_scal_0": weights["voxel_geo_scal"] * geo,
           "loss_depth": weights["depth"] * bce_depth(
               batch["gt_depth"][:, :1], outputs["depth_prob"], downsample,
               dbound)}
    return out
