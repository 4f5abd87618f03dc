"""Streaming (slab-by-slab) voxel losses, port of
``stereoscene_tpu/losses/streaming.py``.

The reference computes its SSC losses on the logits upsampled to the label
grid (occhead.py:291-294). The three active terms are functions of six
global sums, so the upsampled logits and their softmax never need to exist
at full size:

- ``ce``        needs  sum(nll*w), sum(w)
- ``sem_scal``  needs  per-class nom_c = sum(p_c * [t==c]),
                p_sum_c = sum(p_c), t_sum_c = count(t==c) and V = count
                valid; its specificity numerator is
                V - p_sum_c - t_sum_c + nom_c
- ``geo_scal``  is sem_scal's class-0 algebra: intersection =
                (V - t_sum_0) - (p_sum_0 - nom_0), spec = nom_0 / t_sum_0

The JAX package accumulates them in a ``lax.scan`` over Y-slabs of the
native-resolution logits; the port walks the same slabs in a Python loop.
Each slab carries one source row of halo per side (edge rows clamped, as
the full resize clamps them), is upsampled trilinearly with the full
resize's half-pixel formula and cropped to its own rows, and each slab is
checkpointed, so the backward recomputes its upsample and softmax instead
of keeping them. Y is the slab axis, as in the JAX package. The JAX
package takes labels at 1x or 2x the logits' grid; the port takes any
integer factor f (the flagship's labels are 4x its 64x64x8 grid): with
half-pixel centres an output row's two taps lie within one source row of
its own, so one halo row suffices for every f.

Over ranks (``parallel``) the six sums pool through ``all_sum`` before the
losses are formed, so each rank computes the global batch's losses.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import all_sum
from .semkitti import _EPS, _neg_log

_KEYS = ("ce_num", "ce_den", "nom", "p_sum", "t_sum", "v")


def _slab_sums(slab: torch.Tensor, gslab: torch.Tensor, cw: torch.Tensor,
               factor: int):
    """The six sums of one padded slab [B, X, S+2, Z, C] against its
    labels [B, fX, fS, fZ]."""
    b, x, s2, z, c = slab.shape
    vol = slab.float().permute(0, 4, 1, 2, 3)
    if factor > 1:
        vol = F.interpolate(vol, size=(factor * x, factor * s2, factor * z),
                            mode="trilinear", align_corners=False)
    vol = vol[:, :, :, factor:factor * (s2 - 1)]
    flat = vol.permute(0, 2, 3, 4, 1).reshape(-1, c)
    t = gslab.reshape(-1).long()
    valid = t != 255
    validf = valid.float()
    safe = torch.where(valid, t, 0)
    logp = torch.log_softmax(flat, dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = torch.where(valid, cw[safe], torch.zeros_like(nll))
    probs = torch.softmax(flat, dim=-1) * validf[:, None]
    completion = (t[:, None] == torch.arange(c, device=t.device)[None, :]
                  ).float() * validf[:, None]
    return ((nll * w).sum(), w.sum(), (probs * completion).sum(0),
            probs.sum(0), completion.sum(0), validf.sum())


def streaming_voxel_stats(logits: torch.Tensor, gt: torch.Tensor,
                          class_weights,
                          num_chunks: int) -> Dict[str, torch.Tensor]:
    """Global loss sums over the upsampled grid, slab by slab.

    ``logits``: [B, X, Y, Z, C] head output at the native grid.
    ``gt``: [B, fX, fY, fZ] int labels (255 = ignore), f a positive
    integer. Returns fp32 sums: ce_num, ce_den, nom[C], p_sum[C], t_sum[C],
    v, pooled over the ranks."""
    b, x, y, z, c = logits.shape
    factor = gt.shape[1] // x
    if factor < 1 or tuple(gt.shape[1:4]) != (factor * x, factor * y,
                                              factor * z):
        raise ValueError(
            f"streaming loss needs gt at an integer multiple of the grid, "
            f"got logits {tuple(logits.shape)} vs gt {tuple(gt.shape)}")
    if y % num_chunks:
        raise ValueError(f"Y={y} not divisible by num_chunks={num_chunks}")
    s = y // num_chunks
    cw = torch.as_tensor(class_weights, dtype=torch.float32,
                         device=logits.device)
    padded = torch.cat([logits[:, :, :1], logits, logits[:, :, -1:]], dim=2)
    sums = None
    for i in range(num_chunks):
        slab = padded[:, :, i * s:i * s + s + 2]
        gslab = gt[:, :, i * factor * s:(i + 1) * factor * s]
        if torch.is_grad_enabled() and slab.requires_grad:
            part = checkpoint(_slab_sums, slab, gslab, cw, factor,
                              use_reentrant=False)
        else:
            part = _slab_sums(slab, gslab, cw, factor)
        sums = part if sums is None else [a + p for a, p in zip(sums, part)]
    flat = all_sum(torch.cat([v.reshape(-1) for v in sums]))
    out = dict(zip(_KEYS, flat.split([1, 1, c, c, c, 1])))
    for key in ("ce_num", "ce_den", "v"):
        out[key] = out[key][0]
    return out


def losses_from_stats(stats: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """ce / sem_scal / geo_scal from the accumulated sums, with the
    formulas of losses/semkitti.py."""
    nom, p_sum, t_sum, v = (stats["nom"], stats["p_sum"], stats["t_sum"],
                            stats["v"])
    ce = stats["ce_num"] / stats["ce_den"].clamp_min(_EPS)

    not_t_sum = v - t_sum
    spec_nom = v - p_sum - t_sum + nom
    precision = nom / p_sum.clamp_min(_EPS)
    recall = nom / t_sum.clamp_min(_EPS)
    specificity = spec_nom / not_t_sum.clamp_min(_EPS)
    zero = torch.zeros_like(p_sum)
    loss_c = (torch.where(p_sum > 0, _neg_log(precision), zero)
              + torch.where(t_sum > 0, _neg_log(recall), zero)
              + torch.where(not_t_sum > 0, _neg_log(specificity), zero))
    present = (t_sum > 0).float()
    sem = (loss_c * present).sum() / present.sum().clamp_min(1.0)

    nonempty_t = v - t_sum[0]
    nonempty_p = v - p_sum[0]
    intersection = nonempty_t - (p_sum[0] - nom[0])
    geo = (_neg_log(intersection / nonempty_p.clamp_min(_EPS))
           + _neg_log(intersection / nonempty_t.clamp_min(_EPS))
           + _neg_log(nom[0] / t_sum[0].clamp_min(_EPS)))
    return {"ce": ce, "sem_scal": sem, "geo_scal": geo}


def streaming_voxel_losses(logits: torch.Tensor, gt: torch.Tensor,
                           class_weights,
                           num_chunks: int) -> Dict[str, torch.Tensor]:
    """CE + sem_scal + geo_scal on the upsampled grid without building it;
    equal (to fp32 reassociation) to ``resize_trilinear`` of the fp32
    logits to ``gt``'s grid followed by ``ce_ssc_loss``,
    ``sem_scal_loss`` and ``geo_scal_loss``."""
    return losses_from_stats(
        streaming_voxel_stats(logits, gt, class_weights, num_chunks))
