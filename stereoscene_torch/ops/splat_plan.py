"""Host-side static splat plans (numpy), the port of
``stereoscene_tpu/ops/splat_plan.py``.

With image augmentation off and an identity ``bda`` (the scored inference
configuration) the frustum->voxel map depends only on the calibration, so
the argsort and the out-of-bounds compaction run once per calibration on the
host. The plan travels with the batch as three int32 arrays:

  order:        [P_pad] in-bounds point indices sorted by voxel rank. With
                ``group > 1`` every voxel's run is padded to a multiple of
                ``group`` with the sentinel ``P`` (= D*fH*fW, masked on the
                device); the tail pad is ``P`` too (0 for group-1 plans).
  ranks_sorted: [P_pad] ranks in sorted order; the tail pad carries
                ``num_voxels + TILE``.
  bounds:       [num_voxels + 1] boundaries over the group-reduced rows:
                voxel v owns rows [bounds[v]*group, bounds[v+1]*group).

Ranks come from this package's own torch geometry, computed on the CPU
(``BEVDepthOccupancy.compute_ranks``), so the plan never touches the card's
floating point and is identical to the JAX package's plan.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.spans import span

# Plan padding constants shared with the JAX package's plans (its Pallas
# splat tiled output voxels by TILE and plan rows by CHUNK); kept so plans
# are array-identical across the two packages.
TILE = 512
CHUNK = 1024

GEOMETRY_KEYS = ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")


def build_plan(
    ranks: np.ndarray,
    num_voxels: int,
    p_pad: Optional[int] = None,
    group: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """ranks [P] -> (order [P_pad], ranks_sorted [P_pad]).

    ``p_pad`` None sizes the plan to this frame (``plan_budget``). ``group``
    pads every voxel's run of points to a multiple of ``group`` so no block
    of ``group`` consecutive rows straddles a voxel boundary."""
    if group < 1:
        raise ValueError(f"splat group must be >= 1, got {group}")
    if group > 1 and CHUNK % group != 0:
        raise ValueError(
            f"splat group {group} must divide the plan chunk size {CHUNK} "
            f"so padded plans stay group-aligned")
    if p_pad is not None and p_pad % group != 0:
        raise ValueError(
            f"p_pad={p_pad} is not a multiple of splat group {group}")
    p_total = len(ranks)
    order = np.argsort(ranks, kind="stable").astype(np.int32)
    rs = ranks[order]
    keep = rs < num_voxels
    order, rs = order[keep], rs[keep]
    if group > 1 and len(order):
        uniq, counts = np.unique(rs, return_counts=True)
        padded = (counts + group - 1) // group * group
        offsets = np.cumsum(padded) - padded
        seg_start = np.cumsum(counts) - counts
        seg_id = np.repeat(np.arange(len(uniq)), counts)
        pos = offsets[seg_id] + (np.arange(len(order)) - seg_start[seg_id])
        new_order = np.full(int(padded.sum()), p_total, np.int32)
        new_order[pos] = order
        order, rs = new_order, np.repeat(uniq, padded).astype(np.int32)
    n = len(order)
    if p_pad is None:
        p_pad = plan_budget(n)
    if n > p_pad:
        raise ValueError(
            f"splat plan budget too small: {n} rows > p_pad={p_pad}")
    pad = p_pad - n
    order = np.concatenate(
        [order, np.full(pad, p_total if group > 1 else 0, np.int32)])
    rs = np.concatenate([rs, np.full(pad, num_voxels + TILE, np.int32)])
    if group > 1:
        validate_plan_group(rs, group)
    return order, rs


def plan_bounds(
    ranks_sorted: np.ndarray, num_voxels: int, group: int = 1
) -> np.ndarray:
    """[num_voxels + 1] int32 boundaries over the group-reduced rows."""
    rs_pre = np.asarray(ranks_sorted)[::group]
    return np.searchsorted(
        rs_pre, np.arange(num_voxels + 1), side="left").astype(np.int32)


def validate_plan_group(ranks_sorted: np.ndarray, group: int) -> None:
    """Raise if a ``group``-row block of the plan straddles a voxel
    boundary (a plan built with another ``group``)."""
    if group <= 1:
        return
    if len(ranks_sorted) % group != 0:
        raise ValueError(
            f"plan length {len(ranks_sorted)} not a multiple of group {group}")
    blocks = np.asarray(ranks_sorted).reshape(-1, group)
    bad = np.nonzero((blocks != blocks[:, :1]).any(axis=1))[0]
    if len(bad):
        raise ValueError(
            f"splat plan is not group-{group} aligned: {len(bad)} blocks "
            f"straddle voxel boundaries (first at row {bad[0] * group}); "
            f"rebuild it with build_plan(..., group={group})")


def plan_budget(n_valid: int, margin: float = 1.1) -> int:
    """Plan size for a dataset: the in-bounds count x ``margin``, rounded up
    to a CHUNK multiple, plus one CHUNK."""
    n = int(n_valid * margin)
    return (n + CHUNK - 1) // CHUNK * CHUNK + CHUNK


class SplatPlanCache:
    """Per-calibration plan cache.

    ``attach(batch)`` adds 'splat_order' / 'splat_ranks' / 'splat_bounds'
    ([B, ...] int32 tensors on the batch's device) for every sample, reusing
    the plan of a calibration it has seen. The first plan fixes the shared
    ``p_pad`` budget. ``hits`` / ``misses`` count plan lookups."""

    def __init__(self, model):
        cfg = model.cfg
        self.model = model
        self.num_voxels = int(np.prod(cfg.grid_shape))
        self.group = int(cfg.splat_group)
        self.p_pad: Optional[int] = None
        self.hits = 0
        self.misses = 0
        self._cache: Dict[bytes, Tuple[np.ndarray, ...]] = {}

    def _plan(self, sample: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
        key = b"".join(
            np.ascontiguousarray(sample[k], np.float32).tobytes()
            for k in GEOMETRY_KEYS)
        hit = self._cache.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        with span("stereoscene.plan.build"):
            ranks = self.model.compute_ranks(
                {k: torch.from_numpy(sample[k]) for k in GEOMETRY_KEYS}
            )[0].numpy()
            if self.p_pad is None:
                self.p_pad = len(
                    build_plan(ranks, self.num_voxels, group=self.group)[0])
            order, rs = build_plan(ranks, self.num_voxels, self.p_pad,
                                   group=self.group)
            hit = (order, rs, plan_bounds(rs, self.num_voxels, self.group))
        self._cache[key] = hit
        return hit

    def attach(self, batch: Dict[str, torch.Tensor]) -> Dict:
        with span("stereoscene.plan"):
            device = batch["rots"].device
            geo = {k: torch.as_tensor(batch[k]).detach()
                   .to("cpu", torch.float32).numpy() for k in GEOMETRY_KEYS}
            plans = [self._plan({k: v[i:i + 1] for k, v in geo.items()})
                     for i in range(geo["rots"].shape[0])]
            out = dict(batch)
            for j, name in enumerate(("splat_order", "splat_ranks",
                                      "splat_bounds")):
                out[name] = torch.from_numpy(
                    np.stack([p[j] for p in plans])).to(device)
            return out
