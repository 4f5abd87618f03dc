"""Lovasz-softmax loss, port of ``stereoscene_tpu/losses/lovasz.py``
(ref: projects/mmdet3d_plugin/occupancy/dense_heads/lovasz_softmax.py, the
public maxim-berman implementation; weight 0.0 in the active config,
stereoscene.py:120).

``ignore``: masked entries get error 0 and foreground 0, which sorts them
into the zero-error tail, where the Lovasz gradient multiplies a zero
error: the same loss as removing them. The classes' errors sort in one
batched ``torch.sort``. The loss value does not depend on how equal errors
are ordered; its gradient can.

Over ranks (``parallel``) the sort is over the global batch: the
probabilities and labels are gathered from the ranks of ``group`` first
(``all_gather_rows``; every rank by default), so each rank computes the
global loss.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import all_gather_rows


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension w.r.t. sorted errors, along the
    last axis."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, -1)
    union = gts + torch.cumsum(1.0 - gt_sorted, -1)
    jaccard = 1.0 - intersection / union.clamp_min(1e-12)
    return torch.cat([jaccard[..., :1],
                      jaccard[..., 1:] - jaccard[..., :-1]], -1)


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor,
                   ignore: Optional[int] = 255,
                   classes: str = "present", group=None) -> torch.Tensor:
    """Multi-class Lovasz-softmax loss.

    Args:
      probs: [..., C] class probabilities (softmax already applied).
      labels: [...] int labels.
      ignore: label to exclude.
      classes: 'present' averages only over classes present in the target;
        'all' averages over every class.
      group: the ranks whose rows make the batch (None: every rank).
    """
    c = probs.shape[-1]
    probs = all_gather_rows(probs.float().reshape(-1, c), group)
    labels = all_gather_rows(labels.reshape(-1), group)
    valid = (torch.ones_like(labels, dtype=torch.bool) if ignore is None
             else labels != ignore)
    cls = torch.arange(c, device=labels.device, dtype=labels.dtype)
    fg = ((labels[None, :] == cls[:, None]) & valid[None, :]).float()
    errors = torch.where(valid[None, :], (fg - probs.t()).abs(),
                         torch.zeros_like(fg))                   # [C, N]
    errors_sorted, order = torch.sort(errors, dim=1, descending=True,
                                      stable=True)
    fg_sorted = fg.gather(1, order)
    losses = (errors_sorted * _lovasz_grad(fg_sorted)).sum(1)
    if classes == "present":
        present = (fg.sum(1) > 0).float()
        return (losses * present).sum() / present.sum().clamp_min(1.0)
    return losses.mean()
