"""SemanticKITTI SSC losses, port of ``stereoscene_tpu/losses/semkitti.py``
(ref: projects/mmdet3d_plugin/utils/semkitti.py): the class weights
(semkitti.py:8-31), weighted cross-entropy (:140-149), and the scene-class
affinity losses ``sem_scal`` (:93-137) and ``geo_scal`` (:67-91), the
masked KL ``kl_sep`` (:57-64) and the online-hard-example-mining CE
``ohem_ce_ssc_loss`` (:151-185).

Layouts are the JAX package's: ``logits`` channels-last [B, X, Y, Z, C],
``target`` [B, X, Y, Z] with 255 = ignore. Every reduction is fp32
whatever the input dtype. Denominators are clamped, so a batch that is all
ignore gives finite values, not NaN: 0 for CE and sem_scal.

Every loss pools over the global batch, as the JAX package's step over the
sharded global batch does: in a process group (``parallel``) each sum over
voxels (numerators, denominators, per-class counts) goes through
``parallel.all_sum`` before any division or ``where``, so every rank
computes the loss of all ranks' voxels together, and its gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import all_sum, space_rank, spatial

# ref: semkitti.py:8-31
SEMANTIC_KITTI_CLASS_FREQUENCIES = np.array([
    5.41773033e09, 1.57835390e07, 1.25136000e05, 1.18809000e05,
    6.46799000e05, 8.21951000e05, 2.62978000e05, 2.83696000e05,
    2.04750000e05, 6.16887030e07, 4.50296100e06, 4.48836500e07,
    2.26992300e06, 5.68402180e07, 1.57196520e07, 1.58442623e08,
    2.06162300e06, 3.69705220e07, 1.15198800e06, 3.34146000e05,
])

_EPS = 1e-12
_LOG_CLAMP = -100.0  # torch binary_cross_entropy clamps log terms here


def class_weights_from_frequencies(freqs: np.ndarray = None) -> np.ndarray:
    """1 / log(freq + 0.001) class weights (ref: occhead.py:155-157)."""
    if freqs is None:
        freqs = SEMANTIC_KITTI_CLASS_FREQUENCIES
    return (1.0 / np.log(freqs + 0.001)).astype(np.float32)


def _neg_log(p: torch.Tensor) -> torch.Tensor:
    """binary_cross_entropy(p, 1) = -log(p), with torch's clamping."""
    return -torch.log(p.clamp_min(_EPS)).clamp_min(_LOG_CLAMP)


def ce_ssc_loss(logits: torch.Tensor, target: torch.Tensor,
                class_weights) -> torch.Tensor:
    """Weighted cross-entropy, ignore 255, torch's 'mean' reduction (sum
    of weighted losses / sum of the weights)."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float().reshape(-1, c), dim=-1)
    t = target.reshape(-1).long()
    valid = t != 255
    safe = torch.where(valid, t, 0)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)[safe] * valid
    num, den = all_sum(torch.stack([(nll * w).sum(), w.sum()]))
    return num / den.clamp_min(_EPS)


def geo_scal_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary occupancy precision / recall / specificity loss."""
    probs = torch.softmax(logits.float(), dim=-1)
    empty = probs[..., 0].reshape(-1)
    t = target.reshape(-1)
    valid = (t != 255).float()
    nonempty_t = ((t != 0) & (t != 255)).float()
    empty_t = valid - nonempty_t
    nonempty = (1.0 - empty) * valid
    empty = empty * valid
    inter, p_sum, t_sum, spec_nom, e_sum = all_sum(torch.stack([
        (nonempty_t * nonempty).sum(), nonempty.sum(), nonempty_t.sum(),
        (empty_t * empty).sum(), empty_t.sum()]))
    precision = inter / p_sum.clamp_min(_EPS)
    recall = inter / t_sum.clamp_min(_EPS)
    spec = spec_nom / e_sum.clamp_min(_EPS)
    return _neg_log(precision) + _neg_log(recall) + _neg_log(spec)


def sem_scal_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-class precision / recall / specificity loss, averaged over the
    classes present in the valid target. A precision term with no
    predicted mass and a specificity term of a class that fills every valid
    voxel are skipped, as in the reference."""
    c = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, c)
    t = target.reshape(-1)
    validf = (t != 255).float()[:, None]
    classes = torch.arange(c, device=t.device, dtype=t.dtype)
    completion = (t[:, None] == classes[None, :]).float() * validf
    probs = probs * validf
    nominator, p_sum, t_sum, spec_nom, n_valid = all_sum(torch.stack([
        (probs * completion).sum(0), probs.sum(0), completion.sum(0),
        ((1.0 - probs) * (1.0 - completion) * validf).sum(0),
        validf.sum().expand(c)]))
    not_t_sum = n_valid - t_sum
    precision = nominator / p_sum.clamp_min(_EPS)
    recall = nominator / t_sum.clamp_min(_EPS)
    specificity = spec_nom / not_t_sum.clamp_min(_EPS)
    zero = torch.zeros_like(p_sum)
    loss_c = (torch.where(p_sum > 0, _neg_log(precision), zero)
              + torch.where(t_sum > 0, _neg_log(recall), zero)
              + torch.where(not_t_sum > 0, _neg_log(specificity), zero))
    present = (t_sum > 0).float()
    return (loss_c * present).sum() / present.sum().clamp_min(1.0)


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.clamp_min(_EPS)).clamp_min(_LOG_CLAMP)


def kl_sep(p: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """KL divergence restricted to entries where target != 0
    (ref: semkitti.py:57-64, torch F.kl_div(log(p), t, reduction='sum'));
    a sum, so pooled over the ranks."""
    p = p.float()
    target = target.float()
    mask = (target != 0).float()
    per_elem = target * (_safe_log(target) - _safe_log(p))
    return all_sum((per_elem * mask).sum())


def ohem_keep_mask(per_voxel: torch.Tensor, top_k: float) -> torch.Tensor:
    """The voxels OHEM keeps, per sample (row) of per_voxel [B, N] (the
    weighted losses in flat voxel order, -inf where invalid): the top
    ``floor(n_valid * top_k)``, ties at the threshold broken as the JAX
    package's descending sort (``argsort(...)[::-1]``) breaks them, the
    higher flat index first."""
    valid = per_voxel > -float("inf")
    k = torch.floor(valid.sum(1).float() * top_k).long()
    desc = torch.sort(per_voxel, dim=1, descending=True).values
    thr = desc.gather(1, (k - 1).clamp_min(0)[:, None])
    greater = per_voxel > thr
    ties = per_voxel == thr
    # 1 for the tie of highest index, 2 for the next ...
    tie_rank = ties.flip(1).long().cumsum(1).flip(1)
    n_ties = (k - greater.sum(1))[:, None]
    keep = greater | (ties & (tie_rank <= n_ties))
    return keep & (k > 0)[:, None]


def ohem_ce_ssc_loss(logits: torch.Tensor, target: torch.Tensor,
                     class_weights, top_k: float = 0.25) -> torch.Tensor:
    """Online hard-example mining CE (ref: semkitti.py:151-185): per
    sample, the top ``floor(n_valid * top_k)`` weighted losses of its valid
    voxels (``ohem_keep_mask``), summed over the batch and normalised by
    the sum of their class weights (clamped at 1e-4). The selection is per
    sample, so over ranks the two sums pool. On an X slab of a sharded
    grid (``parallel.spatial``; the slab is a contiguous run of each
    sample's flat voxels) the selection is made on the sample's detached
    losses gathered over the space group, and each rank sums its slab's
    kept voxels."""
    c = logits.shape[-1]
    b = logits.shape[0]
    logp = torch.log_softmax(logits.float().reshape(b, -1, c), dim=-1)
    t = target.reshape(b, -1).long()
    valid = t != 255
    safe = torch.where(valid, t, 0)
    nll = -logp.gather(2, safe[..., None])[..., 0]
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)[safe]
    per_voxel = torch.where(valid, nll * w,
                            torch.full_like(nll, -float("inf")))
    n = per_voxel.shape[1]
    whole = spatial.gather_slabs(per_voxel.detach(), dim=1)
    keep = ohem_keep_mask(whole, top_k).narrow(1, space_rank() * n, n)
    zero = torch.zeros_like(w)
    topk_sum, weight_sum = all_sum(torch.stack([
        torch.where(keep, per_voxel, zero).sum(),
        torch.where(keep, w, zero).sum()]))
    return topk_sum / weight_sum.clamp_min(1e-4)
